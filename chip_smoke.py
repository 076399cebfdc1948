#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jlama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Phases, each fatal on failure (exit code 1, no result line):
  1. card   - the GPU's name, and its name and power limit from nvidia-smi;
  2. build  - nvcc builds every kernel of the paths from csrc/, in parallel;
  3. kernels - each kernel against its plain PyTorch version on the card at
              the paths' shapes (Llama-3.2-1B, plus Llama-3.1-8B's w2, head
              size 128 and ragged edges; K1 at M = 1 through its GEMV
              (Llama-3.2-1B's four layer shapes and f32-out lm_head,
              Llama-3.1-8B's four and its lm_head, an uneven N; f32 x at M = 1
              and 16 too), each bit-equal on a second call, at M = 2, 8, 13
              and 16 through its bf16 mma route, at M = 37, 511, 512 and 1024
              (256-token chunks of 4 rows) through its wgmma route, there also
              against its rounding model (x and W rounded to bf16, f32 sums)
              and bit-equal on a second call, with Llama-3.1-8B's four layer
              shapes at M = 512; the summed single-stream decode steps (1B:
              65 launches, also less 65 timed empty launches, the timer's
              floor after its flush; 8B: 129), the summed 16-slot decode step
              and the summed 512-token prefill against torch.matmul's, and the
              host time of one wrapper call at M = 512, 16 and 1), with its
              time, the plain version's
              time, a library call's or yardstick's time (never used by the
              port) and the bound: max(bytes / 3.35 TB/s, operations / 989
              TFLOP/s bf16), the H100 SXM data-sheet peaks. K1 q4 matmul,
              K3 flash prefill (Llama-3.2-1B's heads at T = 512 and 200,
              4 x 256-token serving chunks with a different pos0 per row,
              head size 128, softcap + window, and an f32 1024-token window;
              its bf16 route also against its rounding model, P rounded to
              bf16 per key tile, and bit-equal on a second call; SDPA with the
              boolean mask and, where pos0 = 0 and T = S, is_causal; the host
              time of one wrapper call), K2 paged decode (16 slots, ragged lengths
              1-2048 over 512 pages of 64, bf16 and q8 pools; 32 query heads
              on one KV head; head size 128 with softcap and window; the
              Engine's dense cache, one 2,048-slot row with 640 live keys cut
              to a 1,024-slot window, with SDPA on its live prefix as the
              library call; each bit-equal on a repeat, with the host time of
              one wrapper call), K4 KV write with RoPE on q and k fused
              (q, k, v the split views of one QKV output: the 16-slot
              decode, a 256-token prefill chunk of 4 rows, bf16 and q8
              pools, the Engine's dense cache at T = 1 and 512, head size
              128 and 256; q_rot and float pools exact, q8 within 1 code
              and 1 ulp, bit-equal on a repeat; beside it the unfused chain
              of two apply_rope calls and K4 without RoPE, the parent
              tree's chain as PyTorch calls (two apply_rope, two
              index_put_) and an empty launch; and the write alone, without
              RoPE, at the first cases' shapes),
              K5 W4A8 matmul (Llama-3.2-1B's wqkv, wo, w13, w2 at M = 1, 16,
              256, 512, w13 and w2 at M = 2, 4, 8, 13, the f32-out lm_head at
              M = 1, 16, Llama-3.1-8B's w2 and an uneven N; on either route
              its output must equal the plain version's bit for bit, on a
              second call too, and on an input that quantizes losslessly,
              which holds its int8 activations to q8_quantize(x, 256); bound
              against 1,979 TOP/s int8, and each case's share of it), with K1
              and torch.matmul on a bf16 weight beside it, and at M = 512
              torch._int_mm on the int8 codes (no group scales); the summed
              decode steps at M = 1 and 16, and the step's 65 matmuls on
              distinct weights (K5, and K1 beside it) queued back to back
              and as one replayed CUDA graph, the summed 512-token q4s prefill
              and the host time of one wrapper call at M = 1, 16 and 512; K1,
              K3 and K5 are also held at phase 8's
              shapes: one 1024-token window with f32 activations through the
              unfused projections and the f32-out lm_head;
  4. engine - Llama-3.2-1B at full width (16 layers, random JQ4 weights from
              a seed) through Engine.generate_tokens: a 512-token prompt with
              128 new tokens, a resume of that session, and five
              time-to-first-token runs, every decode step after its key's
              first use one replay of a captured CUDA graph (runtime/
              graphs.py; the number of graphs, the capture seconds and the
              graph pool's memory printed); then the same requests through
              an Engine with decode_graphs=False (the eager yardstick),
              whose greedy ids must be identical; in both the kernels'
              launch counters must match the path's expected counts (a
              replay counts its kernels; K2 takes each decode step's
              attention on the dense cache), and nn.layers.apply_rope must
              not run on the card (K4 rotates q and k on every cached path,
              here and in phases 5-7); then the prefill logits of a
              short prompt are held against the same weights run through the
              plain path on the CPU (relative L2 error < 5e-2, bf16
              activations on the card against f32 on the CPU), and so are
              the logits of a 16-token prefill and 8 decode steps through
              the dense cache (bf16 on the card, K2 for each step);
  5. profile - torch.profiler's device time by kernel and kernel group,
              device operations (per token too) and the device's busy share
              for a 512-token prefill and for 32 decode steps of the Engine
              path, with graphs and eager; the decode
              window must run none of the library kernels the dense
              attention ran before K2 took it (DENSE_ATTN_NAMES);
  6. serving - Llama-3.2-1B through BatchScheduler with the CLI's serving
              defaults (16 slots, 512 pages of 64, bf16 pool, prefill chunk
              256, decode lag 4, max_seq_len 2048): 24 requests made from a
              seed (16 at once through start()/submit(), 8 more while the
              batch runs; 8 seeded with temperature 0.8, top_p 0.95, top_k
              40; a session resumed by a second request; a frequency penalty;
              stop ids), then 4 requests on a q8 pool. warmup() captures the
              greedy and the plain sampled decode graph of every window; every
              decode step after its key's first use must be a replay. Every
              request must end with its count and finish reason, and K1-K4's
              launch counts must equal what the scheduler's counts of prefill
              calls and decode steps imply; then the paged forward's logits
              (a 24-token prefill and 8 decode steps, bf16 and q8 pools) are
              held against the plain f32 path on the CPU (relative L2 <
              5e-2), and 16 greedy requests driven inline must give the same
              ids through the graphs and through a scheduler with
              decode_graphs=False; prints total tok/s, TTFT and inter-token
              p50/p95, and the device's busy share over 16 decode steps at 16
              slots, with graphs and eager;
  7. q4s serving - the same model and serving settings through
              BatchScheduler(weight_format="q4s"): its construction's time
              (fuse and the q4s conversion on the card),
              12 requests from a seed (8 at once, 4 while the batch runs; 4
              seeded at temperature 0.8), K5's launches equal to the formula of
              phase 6's K1 and K1 at 0, the paged logits against the same q4s
              weights through K5's plain version in f32 on the CPU (relative
              L2 < 5e-2), the graphs against the eager yardstick as in phase
              6, and its serving numbers and busy share beside phase 6's;
  8. perplexity - eval.ppl.score_tokens on the card over 2,048 token ids from
              a seed (windows of 1024, stride 512) with the q4 weights and
              their q4s conversion: both perplexities (random weights: only
              their relative delta and the path mean anything), K5 launched in
              the q4s run and K1 in the q4 run only;
  9. design benches - the TPU design benches P1-P3 as card benches
              (jlama_tpu_torch/scripts/): kbench_q4's 25 variants at
              Llama-3.2-1B's four (N, K) and Llama-3.1-8B's two, and
              kbench_w8a8's 10 at (8192, 2048) and (2048, 8192), each at M = 1
              and 16, with torch.matmul on a bf16 weight, K1 and K5 beside
              each shape; probe_int4 (M = 8, 4096 x 4096) and probe_sigma_i16
              (M = 1, 256 x 512). Every kernel against its plain version
              (limits beside the constants), its time, the plain version's time (once
              per function and shape), the bytes it reads and its bound; one
              line per (variant, shape, M), every wrapper launched.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. --out also writes the per-shape details and
the profiles as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

K1_TOL = 2e-2  # max |kernel - plain| <= K1_TOL * max |plain| (bf16 W tiles / bf16 out)
K1_REL_L2 = 1e-2
# K1 past M = 16 against q4_matmul_tiled_plain, its rounding model: the same
# exact bf16 products, f32 sums in another order (K1_MODEL_TOL of max|model|),
# plus one bf16 ulp of the value (2^-7 of it) for a bf16 output
K1_MODEL_TOL, K1_BF16_OUT_REL = 1e-4, 2.0 ** -7
# K3: max |kernel - plain| on N(0, 1) inputs, bf16 in and out / f32 in and out
K3_TOL = {"bf16": 2e-2, "f32": 2e-5}
# K3's bf16 route against flash_prefill_tiled_plain, its rounding model (P
# rounded to bf16 per key tile, as the kernel rounds it): max abs, 5x under
# K3_TOL; the rest is f32 sums in another order and the bf16 output's rounding
K3_MODEL_TOL = 4e-3
# K2 on N(0, 1) inputs: f32 q and out, the JAX tests' tolerances (f32 sums in
# another order; q8 values rounded to bf16 in both); bf16 q and out: each
# element within one bf16 ulp of the plain output (2^-7 of its size, the
# rounding of two f32 results that agree to ~1e-6) plus the f32 limit
K2_TOL = {"bf16": 2e-5, "q8": 3e-3}
K2_BF16_OUT_REL, K2_BF16_OUT_ABS = 2.0 ** -7, 2e-5
LOGITS_REL_L2 = 5e-2
# phase 9 (design benches), each kernel against its plain version on the same
# inputs (jlama_tpu_torch/scripts/_common.py's BF16_REL and F32_REORDER):
# the float variants, and pb8, pgb8 and pk4 (exact int32 dots, an f32 combine
# in another order), within one bf16 ulp of the plain output (2^-7 of it) plus
# 2e-4 max|plain| for the f32 sums in another order (the rank-1 variants
# subtract terms up to ~30x the output); di8, di8b and the sigma probes (one
# exact integer sum, at most one float operation) equal
BENCH_MAIN = (8192, 2048, 1)  # the kernels line's shape: 1B's w13-sized GEMV at M = 1
N_TTFT = 5  # time-to-first-token runs; the median is reported
# K1's device kernels in a profile: the GEMV, the mma route, the wgmma route
K1_NAMES = re.compile(r"q4_(gemv|mma|wgmma)_kernel")
# K5's: the decode kernel, the pre-pass of both routes, the wgmma route
K5_NAMES = re.compile(r"w8a8_(decode|quantize|wgmma)_kernel")
# what the Engine's dense T = 1 attention ran before K2 took it: cuBLAS's
# batched GEMV and f32 GEMM, and PyTorch's softmax
DENSE_ATTN_NAMES = re.compile(r"softmax|cublasGemv|gemmSN|xmma_gemm_f32")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


PPL_TOKENS, PPL_SEQ, PPL_STRIDE = 2048, 1024, 512


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "").replace("float32", "f32").replace("bfloat16", "bf16")


def _ppl_window_cases(c1) -> list[tuple]:
    """The matmuls of one score_tokens window (phase 8): f32 activations at M =
    PPL_SEQ through the unfused projections (wq and wo, wk and wv, w1 and w3
    share a shape) and the lm_head, f32 out."""
    import torch

    D, Hf, V = c1.embedding_length, c1.hidden_length, c1.vocab_size
    kv = c1.n_kv_heads * c1.head_size
    f32 = torch.float32
    shapes = {"wq/wo": (D, D), "wk/wv": (kv, D), "w1/w3": (Hf, D), "w2": (D, Hf),
              "lm_head": (V, D)}
    return [(name, n, k, PPL_SEQ, f32, f32) for name, (n, k) in shapes.items()]


def _host_us(torch, fn, n=200) -> float:
    """Host microseconds of one call: n calls enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def check_k1(torch, timer, details):
    from jlama_tpu_torch.utils.cuda_timer import bound
    from jlama_tpu_torch.models.init import llama_1b_config, llama_8b_config
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.q4_matmul import (q4_matmul, q4_matmul_plain, q4_matmul_tiled_plain,
                                               takes_gemv)

    c1, c8 = llama_1b_config(), llama_8b_config()
    D, Hf, V = c1.embedding_length, c1.hidden_length, c1.vocab_size
    qkv = (c1.n_heads + 2 * c1.n_kv_heads) * c1.head_size
    layer_shapes = {"wqkv": (qkv, D), "wo": (D, D), "w13": (2 * Hf, D), "w2": (D, Hf)}
    D8 = c8.embedding_length
    qkv8 = (c8.n_heads + 2 * c8.n_kv_heads) * c8.head_size
    bf16, f32 = torch.bfloat16, torch.float32
    # M = 1: the GEMV; 2, 8, 13, 16: the mma route (one and two token tiles, a
    # ragged one); 511, 512, 1024 (the scheduler's 256-token chunk x 4 rows):
    # the wgmma route; f32 x at M = 1 and 16 (w13): the GEMV
    cases = [(name, n, k, m, bf16, bf16)
             for m in (1, 2, 8, 13, 16, 511, 512, 1024) for name, (n, k) in layer_shapes.items()]
    cases += [("lm_head", V, D, m, bf16, f32) for m in (1, 2, 8, 13, 16, 512)]
    cases += [("w13", 2 * Hf, D, m, f32, f32) for m in (1, 16)]
    shapes8 = {"8b_wqkv": (qkv8, D8), "8b_wo": (D8, D8), "8b_w13": (2 * c8.hidden_length, D8),
               "8b_w2": (D8, c8.hidden_length)}
    cases += [(name, n, k, m, bf16, bf16) for name, (n, k) in shapes8.items() for m in (1, 512)]
    cases += [("8b_w2", D8, c8.hidden_length, 16, bf16, bf16), ("8b_lm_head", V, D8, 1, bf16, f32)]
    cases += [("uneven_n", 1000, 2048, m, bf16, bf16) for m in (1, 37)]
    cases += _ppl_window_cases(c1)
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = worst_model = 0.0
    per_shape = {}
    host_us = {}
    for name, n, k, m, x_dtype, out_dtype in cases:
        w = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device="cuda",
                                 dtype=torch.uint8),
                   (torch.rand((n, k // 32), generator=g, device="cuda") + 0.5) * 0.0043)
        x = torch.randn((m, k), generator=g, device="cuda").to(x_dtype)
        got = q4_matmul(x, w, out_dtype)
        ref = q4_matmul_plain(x, w.data, w.scales, torch.float32)
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        rel = ((got.float() - ref).norm() / ref.norm()).item()
        if not (err <= K1_TOL * scale and rel <= K1_REL_L2):
            fail(f"K1 {name} M={m} N={n} K={k}: max_abs_err {err} (max|ref| {scale}), "
                 f"rel L2 {rel}")
        del ref
        worst = max(worst, err)
        model_err = None
        gemv = takes_gemv(m, x_dtype)
        if gemv and not torch.equal(q4_matmul(x, w, out_dtype), got):
            fail(f"K1 {name} M={m} N={n} K={k}: a second call of the GEMV gave other bits")
        if m > 16:  # the wgmma route: its rounding model, and the same bits twice
            model = q4_matmul_tiled_plain(x, w.data, w.scales, torch.float32)
            d = (got.float() - model).abs()
            lim = K1_MODEL_TOL * model.abs().max().item()
            if out_dtype == torch.bfloat16:
                lim = lim + K1_BF16_OUT_REL * model.abs()
            model_err = d.max().item()
            if not bool((d <= lim).all()):
                fail(f"K1 {name} M={m} N={n} K={k}: {model_err} from the rounding model "
                     f"(max|model| {model.abs().max().item()})")
            if not torch.equal(q4_matmul(x, w, out_dtype), got):
                fail(f"K1 {name} M={m} N={n} K={k}: a second call gave other bits")
            worst_model = max(worst_model, model_err)
            del model, d, lim
        del got
        wd, xb = w.dequantize(torch.bfloat16), x.to(torch.bfloat16)
        ms = timer(lambda: q4_matmul(x, w, out_dtype))
        plain_ms = timer(lambda: q4_matmul_plain(x, w.data, w.scales, out_dtype))
        lib_ms = timer(lambda: torch.matmul(xb, wd.t()))
        del wd, xb
        if name == "w13" and m in (1, 16, 512) and x_dtype == bf16:
            host_us[m] = _host_us(torch, lambda: q4_matmul(x, w, out_dtype))
        nbytes = m * k * x.element_size() + n * k // 2 + n * k // 32 * 4 \
            + m * n * (4 if out_dtype == torch.float32 else 2)
        b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
        row = dict(kernel="q4_matmul", shape=name, M=m, N=n, K=k, x_dtype=str(x_dtype),
                   max_abs_err=err, rel_l2=rel, model_err=model_err, repeat_bit_equal=gemv
                   or m > 16 or None, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        details.append(row)
        per_shape.setdefault((name, m), row)  # the bf16-x row where f32 x runs the same shape
        print(f"K1 {name:8s} M={m:4d} N={n:6d} K={k:5d} x {_dt(x_dtype)} out {_dt(out_dtype)}: "
              f"{ms:.4f} ms (plain {plain_ms:.4f},"
              f" torch.matmul bf16 {lib_ms:.4f}, bound {b_ms:.4f} by {b_by}) err {err:.3g}"
              + ("" if model_err is None else f", from the model {model_err:.3g}"), flush=True)
    # the JSON line's K1 work: one decode step of the main path (M = 1):
    # 16 layers x (wqkv, wo, w13, w2) + the lm_head
    L = c1.n_layers
    step = [per_shape[(s, 1)] for s in layer_shapes for _ in range(L)] + [per_shape[("lm_head", 1)]]
    summed = {key: sum(r[key] for r in step) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    # the timer's floor: one empty kernel after the same L2 flush, 65 times
    empty_ms = timer(lambda: torch.cuda._sleep(1))
    step_less_empty = summed["ms"] - len(step) * empty_ms
    # Llama-3.1-8B's single-stream step: 32 layers x (wqkv, wo, w13, w2) + its lm_head
    step8 = [per_shape[(s, 1)] for s in shapes8 for _ in range(c8.n_layers)] \
        + [per_shape[("8b_lm_head", 1)]]
    ms8, lib8, bound8 = (sum(r[key] for r in step8) for key in ("ms", "library_ms", "bound_ms"))
    print(f"K1 one single-stream decode step (M=1, {len(step)} launches): K1 "
          f"{summed['ms']:.4f} ms, less {len(step)} empty launches of {empty_ms:.4f} ms (the "
          f"timer's floor after its flush) {step_less_empty:.4f} ms; torch.matmul bf16 "
          f"{summed['library_ms']:.4f} ms, bound {summed['bound_ms']:.4f} ms", flush=True)
    print(f"K1 one Llama-3.1-8B decode step (M=1, {len(step8)} launches): K1 {ms8:.4f} ms, less "
          f"the empty launches {ms8 - len(step8) * empty_ms:.4f} ms; torch.matmul bf16 "
          f"{lib8:.4f} ms, bound {bound8:.4f} ms", flush=True)
    # the serving path's decode step runs the same launches at M = n_slots = 16
    step16 = [per_shape[(s, 16)] for s in layer_shapes for _ in range(L)] + [per_shape[("lm_head", 16)]]
    ms16 = sum(r["ms"] for r in step16)
    bound16 = sum(r["bound_ms"] for r in step16)
    lib16 = sum(r["library_ms"] for r in step16)
    print(f"K1 one decode step at M=16 (the 16-slot serving step): K1 {ms16:.4f} ms, "
          f"torch.matmul bf16 {lib16:.4f} ms, bound {bound16:.4f} ms; at M=1: K1 "
          f"{summed['ms']:.4f} ms", flush=True)
    # the Engine's 512-token prefill bucket: 16 layers x (wqkv, wo, w13, w2)
    # at M = 512 (the lm_head runs on the last position only)
    pre = [per_shape[(s, 512)] for s in layer_shapes for _ in range(L)]
    pre_ms, pre_lib, pre_bound = (sum(r[key] for r in pre)
                                  for key in ("ms", "library_ms", "bound_ms"))
    print(f"K1 one 512-token prefill ({len(pre)} launches at M=512): K1 {pre_ms:.4f} ms, "
          f"torch.matmul bf16 {pre_lib:.4f} ms, bound {pre_bound:.4f} ms", flush=True)
    print(f"K1 host time of one wrapper call (w13): {host_us[512]:.1f} us at M=512 (wgmma "
          f"route, x's tensor map made per call), {host_us[16]:.1f} us at M=16, "
          f"{host_us[1]:.1f} us at M=1 (the plan from a cache)", flush=True)
    return dict(summed, max_abs_err=worst, bound_by="bytes", empty_launch_ms=empty_ms,
                ms_less_empty=step_less_empty, ms_8b=ms8, library_ms_8b=lib8, bound_ms_8b=bound8,
                ms_m16=ms16, bound_ms_m16=bound16,
                library_ms_m16=lib16, max_err_from_model=worst_model,
                ms_prefill512=pre_ms, library_ms_prefill512=pre_lib,
                bound_ms_prefill512=pre_bound, host_us_m512=host_us[512],
                host_us_m16=host_us[16], host_us_m1=host_us[1],
                work="one decode step, M=1: "
                f"{L} x (wqkv, wo, w13, w2) + lm_head = {len(step)} launches; "
                f"*_8b: Llama-3.1-8B's, {c8.n_layers} x 4 + lm_head; "
                f"*_prefill512: one 512-token prefill, {L} x (wqkv, wo, w13, w2) at M=512")


def _lossless_k5_case(torch, QArray, w, m, x_dtype, g):
    """An input that q8_quantize(x, 256) reproduces exactly (integers in
    [-127, 127] times 0.5, each group holding a 127, one all-zero group: codes
    the integers, scales 0.5 or 0) and w with every swk set to 2^-8. Each
    group's (d * 0.5) * 2^-8 is then exact, and so is every f32 sum of them in
    any order while it stays below 2^24 units of 2^-9 (at these shapes a few
    million at most)."""
    k = w.shape[1]
    ints = torch.randint(-127, 128, (m, k), generator=g, device="cuda").float()
    ints[:, ::256] = 127.0
    ints[0, :256] = 0.0
    sigma, swk = w.scales
    return (ints * 0.5).to(x_dtype), QArray(w.data, (sigma, torch.full_like(swk, 2.0 ** -8)),
                                            "q4s")


def check_k5(torch, timer, details):
    from jlama_tpu_torch.utils.cuda_timer import bound, INT8_OPS_PER_S
    from jlama_tpu_torch.models.init import llama_1b_config, llama_8b_config
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul
    from jlama_tpu_torch.ops.w8a8 import (BITS_PER_WEIGHT, decode_max_m, int8_operands,
                                          q4s_matmul, q4s_matmul_plain, to_q4s)

    c1, c8 = llama_1b_config(), llama_8b_config()
    D, Hf, V = c1.embedding_length, c1.hidden_length, c1.vocab_size
    qkv = (c1.n_heads + 2 * c1.n_kv_heads) * c1.head_size
    layer_shapes = {"wqkv": (qkv, D), "wo": (D, D), "w13": (2 * Hf, D), "w2": (D, Hf)}
    bf16, f32 = torch.bfloat16, torch.float32
    # M = 1 (in-launch quantization), 2, 4, 8 (one token tile), 13, 16 (two):
    # the decode route; 256, 512: the wgmma route
    cases = [(name, n, k, m, bf16, bf16)
             for m in (1, 16, 256, 512) for name, (n, k) in layer_shapes.items()]
    cases += [(name, *layer_shapes[name], m, bf16, bf16) for m in (2, 4, 8, 13)
              for name in ("w13", "w2")]
    cases += [("lm_head", V, D, m, bf16, f32) for m in (1, 16)]
    cases += [("8b_w2", c8.embedding_length, c8.hidden_length, m, bf16, bf16)
              for m in (1, 16, 512)]
    cases += [("uneven_n", 1000, 2048, m, bf16, bf16) for m in (1, 37)]
    cases += _ppl_window_cases(c1)
    # rows that are no 16-byte multiple, which the TMA store takes through a
    # padded stride: an odd N in bf16, and GPT-2's tied lm_head (vocabulary
    # 50,257, K 768) in a perplexity window
    cases += [("odd_n", 1001, 2048, 37, bf16, bf16), ("gpt2_lm_head", 50257, 768, PPL_SEQ, f32, f32)]
    g = torch.Generator(device="cuda").manual_seed(11)
    max_decode_m = decode_max_m()
    worst = 0.0
    per_shape = {}
    host_us = {}
    for name, n, k, m, x_dtype, out_dtype in cases:
        q4 = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device="cuda",
                                  dtype=torch.uint8),
                    (torch.rand((n, k // 32), generator=g, device="cuda") + 0.5) * 0.0043)
        w = to_q4s(q4)
        x = torch.randn((m, k), generator=g, device="cuda").to(x_dtype)
        x[0, :256] = 0  # an all-zero activation group: scale 0
        label = f"K5 {name} M={m} N={n} K={k} x {_dt(x_dtype)} out {_dt(out_dtype)}"
        got_raw = q4s_matmul(x, w, out_dtype)
        plain = q4s_matmul_plain(x, w, out_dtype)
        torch.cuda.synchronize()
        err = (got_raw.float() - plain.float()).abs().max().item()
        # either route: the plain version's bits, and the same bits twice
        route = "wgmma" if m > max_decode_m else "decode"
        if not torch.equal(got_raw, plain):
            fail(f"{label}: the {route} route's output differs from the plain version's "
                 f"(max_abs_err {err})")
        if not torch.equal(q4s_matmul(x, w, out_dtype), got_raw):
            fail(f"{label}: a second call gave other bits")
        worst = max(worst, err)
        del got_raw, plain
        # the activation quantization, exactly: on a lossless input every sum
        # is exact, so a single code or scale off shows as an unequal output
        xl, wl = _lossless_k5_case(torch, QArray, w, m, x_dtype, g)
        if not torch.equal(q4s_matmul(xl, wl, out_dtype), q4s_matmul_plain(xl, wl, out_dtype)):
            fail(f"{label}: the output on a lossless input differs from the plain version's "
                 "(the kernel's int8 activations differ from q8_quantize)")
        del xl, wl
        wd, xb = w.dequantize(torch.bfloat16), x.to(torch.bfloat16)
        ms = timer(lambda: q4s_matmul(x, w, out_dtype))
        plain_ms = timer(lambda: q4s_matmul_plain(x, w, out_dtype))
        yard_ms = timer(lambda: torch.matmul(xb, wd.t()))
        k1_ms = timer(lambda: q4_matmul(x, q4, out_dtype))
        del wd, xb
        int_mm_ms = None
        if m == 512:  # the library's int8 GEMM on the same codes, without the group scales
            xq8, wq8 = int8_operands(x, w)
            int_mm_ms = timer(lambda: torch._int_mm(xq8, wq8.t()))
            del xq8, wq8
        if name == "w13" and m in (1, 16, 512):
            host_us[m] = _host_us(torch, lambda: q4s_matmul(x, w, out_dtype))
        out_size = 4 if out_dtype == torch.float32 else 2
        nbytes = n * k * BITS_PER_WEIGHT / 8 + m * k * x.element_size() + m * n * out_size
        b_ms, b_by = bound(nbytes, 2.0 * m * n * k, INT8_OPS_PER_S)
        row = dict(kernel="w8a8_matmul", shape=name, M=m, N=n, K=k, x_dtype=str(x_dtype),
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                   yardstick_ms=yard_ms, k1_ms=k1_ms, int_mm_ms=int_mm_ms, bound_ms=b_ms,
                   bound_by=b_by, bound_share=b_ms / ms)
        details.append(row)
        per_shape.setdefault((name, m), row)  # the bf16-x row where f32 x runs the same shape
        print(f"{label}: {ms:.4f} ms (plain {plain_ms:.4f}, torch.matmul bf16 {yard_ms:.4f}, "
              f"K1 {k1_ms:.4f}"
              + ("" if int_mm_ms is None else f", torch._int_mm {int_mm_ms:.4f}")
              + f", bound {b_ms:.4f} by {b_by}, {b_ms / ms:.3f} of it) err {err:.3g}", flush=True)
    # the JSON line's K5 work: one decode step of the q4s serving path at M = 1
    # and M = 16: 16 layers x (wqkv, wo, w13, w2) + the lm_head, beside K1
    L = c1.n_layers
    steps = {}
    for m in (1, 16):
        step = [per_shape[(s, m)] for s in layer_shapes for _ in range(L)] \
            + [per_shape[("lm_head", m)]]
        steps[m] = {key: sum(r[key] for r in step)
                    for key in ("ms", "plain_ms", "yardstick_ms", "k1_ms", "bound_ms")}
        print(f"K5 one decode step at M={m}: {steps[m]['ms']:.4f} ms (K1 {steps[m]['k1_ms']:.4f},"
              f" torch.matmul bf16 {steps[m]['yardstick_ms']:.4f}, bound "
              f"{steps[m]['bound_ms']:.4f}, {steps[m]['bound_ms'] / steps[m]['ms']:.3f} of it)",
              flush=True)
    # the q4s 512-token prefill: 16 layers x (wqkv, wo, w13, w2) at M = 512
    pre = [per_shape[(s, 512)] for s in layer_shapes for _ in range(L)]
    keys = ("ms", "k1_ms", "yardstick_ms", "bound_ms", "int_mm_ms")
    pre_sum = {key: sum(r[key] for r in pre) for key in keys}
    print(f"K5 one 512-token prefill ({len(pre)} launches at M=512): K5 {pre_sum['ms']:.4f} ms, "
          f"K1 {pre_sum['k1_ms']:.4f} ms, torch.matmul bf16 {pre_sum['yardstick_ms']:.4f} ms, "
          f"torch._int_mm on the int8 codes {pre_sum['int_mm_ms']:.4f} ms, bound "
          f"{pre_sum['bound_ms']:.4f} ms", flush=True)
    graph_steps = _decode_step_graphs(torch, timer, c1, layer_shapes, steps)
    print(f"K5 host time of one wrapper call (w13): {host_us[512]:.1f} us at M=512 (the "
          f"pre-pass, the scratch, three tensor maps made per call), {host_us[16]:.1f} us at "
          f"M=16 (the pre-pass and the decode kernel), {host_us[1]:.1f} us at M=1 (one launch)",
          flush=True)
    return dict(steps[1], library_ms=None, max_abs_err=worst, bound_by="bytes",
                ms_m16=steps[16]["ms"], k1_ms_m16=steps[16]["k1_ms"],
                bound_ms_m16=steps[16]["bound_ms"],
                **{f"{key}_prefill512": v for key, v in pre_sum.items()},
                host_us_m512=host_us[512], host_us_m16=host_us[16], host_us_m1=host_us[1],
                decode_step_graphs=graph_steps,
                work=f"one decode step, M=1: {L} x (wqkv, wo, w13, w2) + lm_head = "
                     f"{4 * L + 1} launches; yardstick: torch.matmul on bf16 weights; "
                     "k1_ms: K1 on the same JQ4 weights; *_prefill512: one 512-token "
                     f"prefill, {L} x (wqkv, wo, w13, w2) at M=512; int_mm: torch._int_mm "
                     "on the int8 codes, without the group scales")


def _decode_step_graphs(torch, timer, c1, layer_shapes, summed) -> dict:
    """K5's decode route without launch gaps (and K1's beside it): the
    matmuls of one decode step, 16 layers x (wqkv, wo, w13, w2) on distinct
    weights + the f32-out lm_head, at M = 1 and 16, timed after one L2 flush
    as 65 wrapper calls queued back to back and as one replay of their
    captured CUDA graph; beside the sum of the 65 launches timed one by one
    after a flush each (`summed`)."""
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul
    from jlama_tpu_torch.ops.w8a8 import q4s_matmul, to_q4s
    from jlama_tpu_torch.utils.cuda_timer import SLEEP_CYCLES

    g = torch.Generator(device="cuda").manual_seed(12)

    def q4(n, k):
        return QArray(torch.randint(0, 256, (n, k // 2), generator=g, device="cuda",
                                    dtype=torch.uint8),
                      (torch.rand((n, k // 32), generator=g, device="cuda") + 0.5) * 0.0043)

    mats = [(q4(n, k), torch.bfloat16) for _ in range(c1.n_layers)
            for n, k in layer_shapes.values()]
    mats.append((q4(c1.vocab_size, c1.embedding_length), torch.float32))
    out = {}
    for route, fn in (("k5", q4s_matmul), ("k1", q4_matmul)):
        ws = [(to_q4s(w) if route == "k5" else w, dt) for w, dt in mats]
        for m in (1, 16):
            xs = {k: torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
                  for k in {w.shape[1] for w, _ in ws}}

            def step():
                for w, dt in ws:
                    fn(xs[w.shape[1]], w, dt)

            # the 65 calls' host time, ten times over, has to fit in the sleep
            eager_ms = timer(step, sleep_cycles=4 * SLEEP_CYCLES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            graph_ms = timer(graph.replay)
            key = "ms" if route == "k5" else "k1_ms"
            out[f"{route}_m{m}"] = dict(summed_ms=summed[m][key], back_to_back_ms=eager_ms,
                                        graph_ms=graph_ms, launches=len(ws))
            print(f"{route.upper()} decode step matmuls at M={m} ({len(ws)} launches, distinct "
                  f"weights): summed one by one {summed[m][key]:.4f} ms, back to back "
                  f"{eager_ms:.4f} ms, one CUDA graph replay {graph_ms:.4f} ms", flush=True)
            del graph, xs
        del ws
    return out


def check_k3(torch, timer, details):
    from jlama_tpu_torch.utils.cuda_timer import bound
    import torch.nn.functional as F

    from jlama_tpu_torch.ops.attention import (KEY_TILE, flash_prefill, flash_prefill_plain,
                                               flash_prefill_tiled_plain)

    H, n_kv = 32, 8
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, T, S, pos0 (one for all rows, or one per row), hd, softcap, window, dtype)
        (1, 512, 512, 0, 64, None, None, bf16),  # the main path's 512-token prefill
        (1, 512, 1024, 512, 64, None, None, bf16),
        (1, 512, 1024, 300, 64, None, None, bf16),
        (1, 512, 512, 0, 128, None, None, bf16),  # Llama-3.1-8B's head size
        (1, 512, 1024, 512, 128, None, None, bf16),
        (2, 512, 1024, 400, 128, 30.0, 256, bf16),  # softcap + window
        (1, 200, 333, 100, 64, None, None, bf16),  # ragged T and S
        (4, 256, 1024, (0, 256, 512, 768), 64, None, None, bf16),  # serving chunks, 4 rows
        (2, 256, 1024, (128, 640), 128, None, None, bf16),
        (1, PPL_SEQ, PPL_SEQ, 0, 64, None, None, f32),  # a score_tokens window (phase 8)
    ]
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = worst_model = 0.0
    main = host_us = None
    for B, T, S, p0, hd, cap, win, dtype in cases:
        q = torch.randn((B, H, T, hd), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, n_kv, S, hd), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, n_kv, S, hd), generator=g, device="cuda").to(dtype)
        rows = p0 if isinstance(p0, tuple) else (p0,) * B
        pos0 = torch.tensor(rows, dtype=torch.int32, device="cuda")
        scale = hd ** -0.5
        label = f"K3 B={B} T={T} S={S} pos0={p0} hd={hd} {_dt(dtype)}"

        def run():
            return flash_prefill(q, k, v, pos0, scale, softcap=cap, window=win)

        got = run()
        ref = flash_prefill_plain(q, k, v, pos0, scale, softcap=cap, window=win).float()
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        if not err <= K3_TOL[_dt(dtype)]:
            fail(f"{label}: max_abs_err {err}")
        worst = max(worst, err)
        model_err = None
        if dtype == bf16:  # the tensor-core route: its rounding model, the same bits twice
            model = flash_prefill_tiled_plain(q, k, v, pos0, scale, softcap=cap, window=win,
                                              block_s=KEY_TILE[hd])
            model_err = (got.float() - model.float()).abs().max().item()
            if not model_err <= K3_MODEL_TOL:
                fail(f"{label}: {model_err} from the rounding model (limit {K3_MODEL_TOL})")
            if not torch.equal(run(), got):
                fail(f"{label}: a second call gave other bits")
            worst_model = max(worst_model, model_err)
            del model
        del got, ref
        ms = timer(run)
        plain_ms = timer(lambda: flash_prefill_plain(q, k, v, pos0, scale, softcap=cap,
                                                     window=win))
        qp = pos0[:, None, None] + torch.arange(T, device="cuda")[None, :, None]
        kp = torch.arange(S, device="cuda")[None, None, :]
        mask = kp <= qp  # [B, T, S]
        if win is not None:
            mask &= kp > qp - win
        live_pairs = int(mask.sum().item()) * H
        sdpa_mask_ms = sdpa_causal_ms = None
        if cap is None:  # SDPA has no softcap
            sdpa_mask_ms = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None], scale=scale, enable_gqa=True))
            if win is None and T == S and set(rows) == {0}:  # the same function, top-left causal
                sdpa_causal_ms = timer(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=scale, enable_gqa=True))
        sdpa = [t for t in (sdpa_mask_ms, sdpa_causal_ms) if t is not None]
        lib_ms = min(sdpa) if sdpa else None
        nbytes = q.element_size() * (2 * B * H * T * hd + 2 * B * n_kv * S * hd)
        b_ms, b_by = bound(nbytes, 4.0 * hd * live_pairs)
        row = dict(kernel="flash_prefill", B=B, H=H, n_kv=n_kv, T=T, S=S, pos0=list(rows), hd=hd,
                   softcap=cap, window=win, dtype=str(dtype), max_abs_err=err,
                   model_err=model_err, ms=ms, plain_ms=plain_ms, sdpa_mask_ms=sdpa_mask_ms,
                   sdpa_causal_ms=sdpa_causal_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        if main is None:
            main = row
            host_us = _host_us(torch, run)
            row["host_us"] = host_us
        details.append(row)
        print(f"K3 B={B} T={T:4d} S={S:5d} pos0={p0} hd={hd:3d} cap={cap} win={win} "
              f"{_dt(dtype)}: {ms:.4f} ms (plain {plain_ms:.4f}, sdpa masked {sdpa_mask_ms}, "
              f"sdpa is_causal {sdpa_causal_ms}, bound {b_ms:.4f} by {b_by}) err {err:.3g}"
              + ("" if model_err is None else f", from the model {model_err:.3g}"), flush=True)
    L = 16
    summed = {key: main[key] * L for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"K3 one 512-token prefill ({L} launches at B=1, T=S=512, hd=64): K3 "
          f"{summed['ms']:.4f} ms, plain {summed['plain_ms']:.4f}, sdpa masked "
          f"{main['sdpa_mask_ms'] * L:.4f}, sdpa is_causal {main['sdpa_causal_ms'] * L:.4f}, "
          f"bound {summed['bound_ms']:.4f}; host time of one wrapper call {host_us:.1f} us "
          "(three tensor maps made in it)", flush=True)
    return dict(summed, bound_by=main["bound_by"], max_abs_err=worst,
                max_err_from_model=worst_model, host_us=host_us,
                sdpa_mask_ms=main["sdpa_mask_ms"] * L, sdpa_causal_ms=main["sdpa_causal_ms"] * L,
                work=f"one 512-token prefill of the main path: {L} launches at B=1, H=32, "
                     "n_kv=8, T=S=512, pos0=0, hd=64; library_ms: the faster of SDPA with the "
                     "boolean mask and SDPA is_causal=True")


# 16 rows of ragged live lengths for the paged kernels: 208 pages of 64 in
# all; the rows of length 1 are empty decode slots on the scratch page
K2_LENGTHS = [1, 2048, 1500, 1024, 777, 64, 65, 300, 2000, 129, 1, 513, 1800, 256, 999, 1234]
N_PAGES, PAGE, P_MAX = 512, 64, 32


def _page_tables(torch, lengths, g):
    """[B, P_MAX] int32: distinct random pages (1 .. N_PAGES-1) per row for
    its live length; rows of length 1 stay on the scratch page 0."""
    pt = torch.zeros((len(lengths), P_MAX), dtype=torch.int32)
    perm = (torch.randperm(N_PAGES - 1, generator=g) + 1).to(torch.int32)
    nxt = 0
    for b, ln in enumerate(lengths):
        if ln == 1:
            continue
        n = -(-ln // PAGE)
        pt[b, :n] = perm[nxt:nxt + n]
        nxt += n
    return pt.cuda()


def _pools(torch, kind, n_kv, hd, g):
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.quant.blockq import q8_quantize

    pools = []
    for _ in range(2):
        x = torch.randn((n_kv, N_PAGES, PAGE, hd), generator=g, device="cuda")
        if kind == "q8":
            d, sc = q8_quantize(x)
            pools.append(QArray(d, sc, "q8"))
        else:
            pools.append(x.to(torch.bfloat16))
    return pools


def _kv_bytes_per_key(kind, hd):
    return hd * 1 + hd // 32 * 4 if kind == "q8" else hd * 2


# the Engine's dense decode through K2: one row of a 2,048-slot bf16 cache
# with 640 live keys, cut to the Engine's window bucket for them (1,024)
DENSE_S, DENSE_WIN, DENSE_LIVE = 2048, 1024, 640


def check_k2(torch, timer, details):
    from jlama_tpu_torch.utils.cuda_timer import bound
    import torch.nn.functional as F

    from jlama_tpu_torch.ops.attention import paged_decode, paged_decode_plain
    from jlama_tpu_torch.ops.kv_write import dense_page_table, dense_pool_view

    cases = [  # (label, H, n_kv, hd, pool kind, softcap, window)
        ("serving", 32, 8, 64, "bf16", None, None),
        ("serving", 32, 8, 64, "q8", None, None),
        ("mqa g=32", 32, 1, 64, "bf16", None, None),
        ("hd128 cap+win", 32, 8, 128, "bf16", 30.0, 256),
        ("dense engine", 32, 8, 64, "bf16", None, None),
    ]
    g = torch.Generator(device="cuda").manual_seed(4)
    gc = torch.Generator().manual_seed(4)
    worst, main, dense = 0.0, None, None
    for label, H, n_kv, hd, kind, cap, win in cases:
        if label == "dense engine":  # [1, n_kv, S, hd] cut to the window: one page
            lens = [DENSE_LIVE]
            kc, vc = (torch.randn((1, n_kv, DENSE_S, hd), generator=g, device="cuda")
                      .to(torch.bfloat16) for _ in range(2))
            kp, vp = dense_pool_view(kc[:, :, :DENSE_WIN]), dense_pool_view(vc[:, :, :DENSE_WIN])
            pt = dense_page_table(1, torch.device("cuda"))
        else:
            lens = K2_LENGTHS
            kp, vp = _pools(torch, kind, n_kv, hd, g)
            pt = _page_tables(torch, K2_LENGTHS, gc)
        B = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q32 = torch.randn((B, H, hd), generator=g, device="cuda")
        q16 = q32.to(torch.bfloat16)
        scale = hd ** -0.5

        def call(q):
            return paged_decode(q, kp, vp, pt, lengths, scale, cap, win)

        def plain(q):
            return paged_decode_plain(q, kp, vp, pt, lengths, scale, cap, win)

        got, ref = call(q32), plain(q32)
        got16, ref16 = call(q16), plain(q16)
        again = call(q16)
        torch.cuda.synchronize()
        bit_equal = torch.equal(again, got16)
        err = (got - ref).abs().max().item()
        d16 = (got16.float() - ref16.float()).abs()
        err16 = d16.max().item()
        # worst |got16 - ref16| over its limit: <= 1 passes
        ulps16 = (d16 / (K2_BF16_OUT_REL * ref16.float().abs() + K2_BF16_OUT_ABS)).max().item()
        if not (err <= K2_TOL[kind] and ulps16 <= 1.0 and bit_equal):
            fail(f"K2 {label} {kind} hd={hd}: max_abs_err {err} (f32 q, limit {K2_TOL[kind]}), "
                 f"{err16} (bf16 q; {ulps16:.3g} of the limit 2^-7 |plain| + "
                 f"{K2_BF16_OUT_ABS}), bit-equal on a repeat: {bit_equal}")
        worst = max(worst, err)
        ms = timer(lambda: call(q16))
        plain_ms = timer(lambda: plain(q16))
        host_us = _host_us(torch, lambda: call(q16))
        # the live keys of each row, and the yardsticks: for the paged cases
        # the gather of the row's pages (dequantized for q8) followed by SDPA
        # (two calls, so no "library" time); for the dense row one SDPA call
        # on its live prefix
        live = [ln - (max(0, ln - win) if win else 0) for ln in lens]
        yard_ms = lib_ms = None
        if label == "dense engine":
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                q16[:, :, None], kc[:, :, :DENSE_LIVE], vc[:, :, :DENSE_LIVE], scale=scale,
                enable_gqa=True))
        elif cap is None:
            kpos = torch.arange(P_MAX * PAGE, device="cuda")[None, :]
            mask = kpos < lengths[:, None].long()

            def gather(pool):
                if kind == "q8":
                    d, sc = pool.data[:, pt.long()], pool.scales[:, pt.long()]
                    x = (d.float().reshape(*d.shape[:-1], -1, 32) * sc[..., None]).reshape(
                        d.shape).to(torch.bfloat16)
                else:
                    x = pool[:, pt.long()]
                return x.permute(1, 0, 2, 3, 4).reshape(B, n_kv, P_MAX * PAGE, hd)

            yard_ms = timer(lambda: F.scaled_dot_product_attention(
                q16[:, :, None], gather(kp), gather(vp), attn_mask=mask[:, None, None, :],
                scale=scale, enable_gqa=True))
        nbytes = sum(live) * n_kv * 2 * _kv_bytes_per_key(kind, hd) + 2 * (2 * B * H * hd) \
            + pt.numel() * 4 + B * 4
        b_ms, b_by = bound(nbytes, 4.0 * H * hd * sum(live))
        row = dict(kernel="paged_decode", case=label, pool=kind, B=B, H=H, n_kv=n_kv, hd=hd,
                   page_size=kp.shape[2] if kind != "q8" else PAGE, lengths=lens, softcap=cap,
                   window=win, max_abs_err=err, max_abs_err_bf16_out=err16,
                   bf16_out_of_limit=ulps16, bit_equal_repeat=bit_equal, ms=ms,
                   plain_ms=plain_ms, yardstick_ms=yard_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, host_us=host_us)
        details.append(row)
        main = main or row
        if label == "dense engine":
            dense = row
        print(f"K2 {label:13s} {kind:4s} hd={hd:3d} B={B} H={H} n_kv={n_kv} cap={cap} win={win}:"
              f" {ms:.4f} ms (plain {plain_ms:.4f}, yardstick gather+sdpa {yard_ms}, sdpa "
              f"{lib_ms}, bound {b_ms:.4f} by {b_by}, {b_ms / ms:.3f} of it) err {err:.3g} "
              f"(bf16 out {err16:.3g}, {ulps16:.3g} of its limit), bit-equal repeat, host "
              f"{host_us:.1f} us a call", flush=True)
        del kp, vp
    L = 16
    return dict(ms=main["ms"] * L, plain_ms=main["plain_ms"] * L, library_ms=None,
                yardstick_ms=main["yardstick_ms"] * L, bound_ms=main["bound_ms"] * L,
                bound_by=main["bound_by"], max_abs_err=worst, host_us=main["host_us"],
                engine_step_ms=dense["ms"] * L, engine_step_library_ms=dense["library_ms"] * L,
                engine_step_bound_ms=dense["bound_ms"] * L,
                work=f"one 16-slot decode step: {L} launches at B=16, H=32, n_kv=8, hd=64, "
                     "bf16 pool, ragged lengths 1-2048 (K2_LENGTHS); engine_step: one "
                     f"single-stream decode step, {L} launches on the dense cache (1 row, "
                     f"{DENSE_LIVE} live keys, window {DENSE_WIN}), library: SDPA on the live "
                     "prefix")


def _q8_close(torch, a, b) -> tuple[int, int]:
    """(max |payload diff|, max scale diff in ulps) of two q8 pools."""
    dd = (a.data.int() - b.data.int()).abs().max().item()
    du = (a.scales.view(torch.int32).long() - b.scales.view(torch.int32).long()).abs().max().item()
    return dd, du


def check_k4(torch, timer, details):
    """K4 against its plain version. The RoPE cases are the main path's call
    (q, k and v as the split views of one fused QKV output, rotated by
    cos/sin, q_rot returned): each also against the unfused chain (two
    `apply_rope` and K4 without RoPE), the parent tree's chain as PyTorch
    calls where the pool is float (two `apply_rope` and one `index_put_` per
    pool: the yardstick) and an empty launch after the same flush. The cases
    without RoPE are the write alone (models without RoPE)."""
    from jlama_tpu_torch.utils.cuda_timer import bound
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.nn.rope import apply_rope
    from jlama_tpu_torch.ops.kv_write import (
        _slots, dense_page_table, dense_pool_view, kv_write, kv_write_plain)

    H, n_kv = 32, 8
    g = torch.Generator(device="cuda").manual_seed(5)
    gc = torch.Generator().manual_seed(5)
    empty_ms = timer(lambda: torch.cuda._sleep(1))
    worst = 0.0
    main = None
    cases = [  # (label, B, T, hd, pool kind, RoPE)
        ("decode", 16, 1, 64, "bf16", True), ("decode", 16, 1, 64, "q8", True),
        ("prefill chunk", 4, 256, 64, "bf16", True), ("prefill chunk", 4, 256, 64, "q8", True),
        ("engine dense", 1, 1, 64, "bf16", True), ("engine dense", 1, 512, 64, "bf16", True),
        ("decode hd128", 16, 1, 128, "bf16", True), ("decode hd256", 16, 1, 256, "bf16", True),
        ("decode", 16, 1, 64, "bf16", False), ("decode", 16, 1, 64, "q8", False),
        ("prefill chunk", 4, 256, 64, "bf16", False), ("prefill chunk", 4, 256, 64, "q8", False),
        ("engine dense", 1, 1, 64, "bf16", False), ("engine dense", 1, 512, 64, "bf16", False)]
    print(f"K4: an empty launch after the flush {empty_ms:.4f} ms", flush=True)
    for label, B, T, hd, kind, rope in cases:
        if label == "engine dense":
            S = 2048
            caches = [torch.randn((B, n_kv, S, hd), generator=g, device="cuda").to(torch.bfloat16)
                      for _ in range(2)]
            pools = [dense_pool_view(c) for c in caches]
            pt = dense_page_table(B, "cuda")
            p0 = 700 if T == 1 else 0
            pos = (p0 + torch.arange(T, device="cuda"))[None, :].expand(B, T)
            scratch = False
        else:
            pools = _pools(torch, kind, n_kv, hd, g)
            if T == 1:
                pt = _page_tables(torch, K2_LENGTHS, gc)
                pos = (torch.tensor(K2_LENGTHS, device="cuda") - 1)[:, None]
                scratch = True  # the empty slots write into page 0
            else:
                perm = (torch.randperm(N_PAGES - 1, generator=gc) + 1).to(torch.int32)
                pt = perm[: B * P_MAX].reshape(B, P_MAX).cuda()
                p0 = torch.randint(0, P_MAX * PAGE - T, (B,), generator=gc).cuda()
                pos = p0[:, None] + torch.arange(T, device="cuda")[None, :]
                scratch = False
        qkv = torch.randn((B, T, (H + 2 * n_kv) * hd), generator=g, device="cuda").to(
            torch.bfloat16)
        q, kn, vn = qkv.split((H * hd, n_kv * hd, n_kv * hd), dim=-1)
        q, kn, vn = q.reshape(B, T, H, hd), kn.reshape(B, T, n_kv, hd), vn.reshape(B, T, n_kv, hd)
        inv = 1.0 / (500000.0 ** (torch.arange(0, hd, 2, device="cuda").float() / hd))
        ang = pos[..., None].float() * inv
        rot = dict(q=q, cos=torch.cos(ang), sin=torch.sin(ang)) if rope else {}

        def clone(p):
            if isinstance(p, QArray):
                return QArray(p.data.clone(), p.scales.clone(), "q8")
            return p.clone()

        mine, again, plain = ([clone(p) for p in pools] for _ in range(3))
        got = kv_write(mine[0], mine[1], kn, vn, pt, pos, **rot)
        rep = kv_write(again[0], again[1], kn, vn, pt, pos, **rot)
        ref = kv_write_plain(plain[0], plain[1], kn, vn, pt, pos, **rot)
        torch.cuda.synchronize()
        live = slice(1, None) if scratch else slice(None)  # page 0: racing pad writes
        bit_equal = not rope or torch.equal(rep, got)
        if rope and not torch.equal(got, ref):
            fail(f"K4 {label} hd={hd} B={B} T={T}: q_rot differs from the plain version by "
                 f"{(got.float() - ref.float()).abs().max().item()} (must be exact)")
        if kind == "q8":
            dd, du = 0, 0
            for a, b, c in zip(mine, plain, again):
                x, y = _q8_close(torch, QArray(a.data[:, live], a.scales[:, live], "q8"),
                                 QArray(b.data[:, live], b.scales[:, live], "q8"))
                dd, du = max(dd, x), max(du, y)
                bit_equal &= torch.equal(a.data[:, live], c.data[:, live]) \
                    and torch.equal(a.scales[:, live], c.scales[:, live])
            err = float(dd)
            if dd > 1 or du > 1:
                fail(f"K4 {label} q8 B={B} T={T}: payload differs by {dd}, scales by {du} ulp")
        else:
            err = max((a[:, live].float() - b[:, live].float()).abs().max().item()
                      for a, b in zip(mine, plain))
            bit_equal &= all(torch.equal(a[:, live], c[:, live]) for a, c in zip(mine, again))
            if err != 0.0:
                fail(f"K4 {label} {kind} B={B} T={T}: max_abs_err {err} (must be exact)")
        if not bit_equal:
            fail(f"K4 {label} {kind} hd={hd} B={B} T={T}: a repeat is not equal bit for bit")
        worst = max(worst, err)
        ms = timer(lambda: kv_write(mine[0], mine[1], kn, vn, pt, pos, **rot))
        plain_ms = timer(lambda: kv_write_plain(plain[0], plain[1], kn, vn, pt, pos, **rot))
        host_us = _host_us(torch, lambda: kv_write(mine[0], mine[1], kn, vn, pt, pos, **rot))
        unfused_ms = yard_ms = lib_ms = None
        pages, offs, _ = _slots(pt, pos, pools[0].shape[2] if kind != "q8" else PAGE)
        if rope:  # the chain before the fusion: RoPE as ATen calls, then K4 alone

            def unfused():
                apply_rope(q, rot["cos"], rot["sin"])
                kv_write(mine[0], mine[1], apply_rope(kn, rot["cos"], rot["sin"]), vn, pt, pos)

            unfused_ms = timer(unfused)
        if kind == "bf16":  # one index_put_ per pool, after RoPE as ATen calls where it runs
            rv = vn.reshape(B * T, n_kv, hd).transpose(0, 1)

            def lib():
                k = apply_rope(kn, rot["cos"], rot["sin"]) if rope else kn
                if rope:
                    apply_rope(q, rot["cos"], rot["sin"])
                plain[0][:, pages, offs] = k.reshape(B * T, n_kv, hd).transpose(0, 1)
                plain[1][:, pages, offs] = rv

            if rope:
                yard_ms = timer(lib)
            else:
                lib_ms = timer(lib)
        # each input read once (q, k, v, cos/sin, positions, one page-table
        # entry a row), each output written once (q_rot, the pool slots with
        # their q8 scales); the rotation's 6 operations a pair
        rows = B * T
        nbytes = rows * (2 * n_kv * (hd * 2 + _kv_bytes_per_key(kind, hd)) + 8 + 4)
        ops = 0.0
        if rope:
            nbytes += rows * (2 * H * hd * 2 + 2 * (hd // 2) * 4)
            ops = rows * (H + n_kv) * (hd // 2) * 6.0
        b_ms, b_by = bound(nbytes, ops)
        row = dict(kernel="kv_write", case=label, pool=kind, rope=rope, B=B, T=T,
                   H=H if rope else 0, n_kv=n_kv, hd=hd, max_abs_err=err,
                   bit_equal_repeat=bit_equal, ms=ms,
                   plain_ms=plain_ms, unfused_ms=unfused_ms, yardstick_ms=yard_ms,
                   library_ms=lib_ms, empty_launch_ms=empty_ms, bound_ms=b_ms, bound_by=b_by,
                   host_us=host_us)
        details.append(row)
        main = main or row
        print(f"K4 {label:13s} {kind:4s} {'rope' if rope else 'kv  '} hd={hd:3d} B={B:2d} "
              f"T={T:3d}: {ms:.4f} ms (plain {plain_ms:.4f}, unfused apply_rope x2 + K4 "
              f"{unfused_ms}, yardstick apply_rope x2 + index_put_ x2 {yard_ms}, index_put_ x2 "
              f"{lib_ms}, empty launch {empty_ms:.4f}, bound {b_ms:.5f} by {b_by}) err "
              f"{err:.3g}, bit-equal repeat, host {host_us:.1f} us a call", flush=True)
    L = 16
    return dict(ms=main["ms"] * L, plain_ms=main["plain_ms"] * L, library_ms=None,
                yardstick_ms=main["yardstick_ms"] * L, unfused_ms=main["unfused_ms"] * L,
                empty_launch_ms=empty_ms, bound_ms=main["bound_ms"] * L, bound_by=main["bound_by"],
                max_abs_err=worst, host_us=main["host_us"],
                work=f"one 16-slot decode step: {L} launches at B=16, T=1, H=32, n_kv=8, hd=64, "
                     "bf16 pool, RoPE on q and k fused; library: none (no one PyTorch call "
                     "rotates and writes a paged pool); yardstick: the parent tree's chain as "
                     "PyTorch calls, apply_rope x2 and one index_put_ per pool; unfused: "
                     "apply_rope x2 and K4 without RoPE")


def _graph_check(label, graphs, before: dict, n_steps: int) -> dict:
    """The decode graphs of one phase (`runtime/graphs.py`): every decode
    step after a key's first use is one replay, and each new key's first use
    its only eager step. Returns the phase's counts, capture seconds and
    the pool's memory (torch.cuda.memory_reserved before and after each
    capture, summed)."""
    now = graphs.stats()
    d = {k: now[k] - before[k] for k in now}
    out = dict(graphs=now["graphs"], new_graphs=d["graphs"], new_keys=d["keys"],
               eager_steps=d["eager_steps"], replays=d["replays"], decode_steps=n_steps,
               capture_s=d["capture_s"], capture_s_total=now["capture_s"],
               pool_mb=now["pool_bytes"] / 2**20, new_pool_mb=d["pool_bytes"] / 2**20)
    print(f"{label}: decode graphs {now['graphs']} ({d['graphs']} captured in this phase, "
          f"{d['capture_s']:.3f} s; {now['capture_s']:.3f} s in all), pool "
          f"{now['pool_bytes'] / 2**20:.1f} MB "
          f"(+{d['pool_bytes'] / 2**20:.1f}); {n_steps} decode steps = {d['replays']} replays + "
          f"{d['eager_steps']} first uses of {d['keys']} new keys", flush=True)
    if not graphs.capture or now["graphs"] == 0:
        fail(f"{label}: no decode graph was captured")
    if d["eager_steps"] != d["keys"] or d["replays"] != n_steps - d["eager_steps"]:
        fail(f"{label}: {d['eager_steps']} eager steps for {d['keys']} new keys, "
             f"{d['replays']} replays for {n_steps} decode steps")
    return out


def main_path(torch, card_note):
    from jlama_tpu_torch.models.base import forward_logits, params_to
    from jlama_tpu_torch.models.init import llama_1b_config, random_q4_params
    from jlama_tpu_torch.ops.attention import flash_prefill, paged_decode
    from jlama_tpu_torch.ops.kv_write import kv_write
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul
    from jlama_tpu_torch.runtime.engine import Engine

    cfg = llama_1b_config()
    t0 = time.perf_counter()
    eng = Engine(random_q4_params(cfg, seed=0, device="cuda"), cfg, device="cuda",
                 max_seq_len=2048)
    torch.cuda.synchronize()
    print(f"main path: Llama-3.2-1B shapes, {cfg.n_layers} layers, random JQ4 weights "
          f"(seed 0), set-up {time.perf_counter() - t0:.2f} s", flush=True)
    # the eager yardstick: the same weights, every decode step issued from Python
    eager = Engine(eng.params, cfg, device="cuda", max_seq_len=2048, fuse=False,
                   decode_graphs=False)
    rng = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()
    more = torch.randint(0, cfg.vocab_size, (64,), generator=rng).tolist()
    n_prefill, n_decode = N_TTFT + 2, N_TTFT + 128 + 32
    per_layer_k1 = 4
    expect = {"q4_matmul": n_prefill * per_layer_k1 * cfg.n_layers
              + n_decode * (per_layer_k1 * cfg.n_layers + 1),
              "flash_prefill": n_prefill * cfg.n_layers,
              "kv_write": (n_prefill + n_decode) * cfg.n_layers,
              "paged_decode": n_decode * cfg.n_layers}  # K2 on the dense cache

    def drive(e, label):
        # a warm-up at the timed shapes (prefill bucket 512, decode window
        # 1024), so that the TTFT holds no first-use cost of the allocator or
        # cuBLAS, nor a graph's capture
        e.generate_tokens(prompt, max_new_tokens=2, stop_ids=set(), session_id="warm")
        e.drop_session("warm")
        torch.cuda.synchronize()
        for k in (q4_matmul, flash_prefill, paged_decode, kv_write):
            k.launches = 0
        _unfused_rope_calls(reset=True)
        graphs0 = e.graphs.stats()
        ttfts, firsts = [], []
        for i in range(N_TTFT):  # each a new session: prefill + first token
            t1 = time.perf_counter()
            firsts.append(e.generate_tokens(prompt, max_new_tokens=1, stop_ids=set(),
                                            session_id=f"ttft{i}"))
            torch.cuda.synchronize()
            ttfts.append((time.perf_counter() - t1) * 1000)
            e.drop_session(f"ttft{i}")
        resp = e.generate_tokens(prompt, max_new_tokens=128, stop_ids=set(), session_id="main")
        resumed = e.generate_tokens(more, max_new_tokens=32, stop_ids=set(), session_id="main")
        torch.cuda.synchronize()
        launches = {"q4_matmul": q4_matmul.launches, "flash_prefill": flash_prefill.launches,
                    "kv_write": kv_write.launches, "paged_decode": paged_decode.launches}
        if _unfused_rope_calls():
            fail(f"engine path: apply_rope ran {_unfused_rope_calls()} times on the card apart "
                 "from K4 (a cached path rotates q and k in K4 only)")
        print(f"engine path ({label}) launches {launches}, expected {expect} "
              f"({per_layer_k1 * cfg.n_layers + 1} K1, {cfg.n_layers} K2 and {cfg.n_layers} K4 "
              f"per decode step, {cfg.n_layers} K3 and {cfg.n_layers} K4 per prefill)", flush=True)
        if launches != expect or min(launches.values()) == 0:
            fail(f"launch counts ({label}) {launches} != expected {expect}")
        for r, n in [(f, 1) for f in firsts] + [(resp, 128), (resumed, 32)]:
            if len(r.token_ids) != n or not all(0 <= t < cfg.vocab_size for t in r.token_ids):
                fail(f"bad token ids ({label}): {r.token_ids[:8]}... ({len(r.token_ids)} of {n})")
        if len({f.token_ids[0] for f in firsts}) != 1 \
                or firsts[0].token_ids[0] != resp.token_ids[0]:
            fail(f"greedy first tokens of the same prompt differ between runs ({label})")
        if e.sessions["main"].position != 512 + 128 + 64 + 32 - 1:
            fail(f"session position ({label}) {e.sessions['main'].position}")
        ttft_ms = statistics.median(ttfts)
        decode_tps = 128 / (resp.generate_time_ms / 1000)
        print(f"TTFT ({label}; 512-token prompt, first token) median {ttft_ms:.2f} ms of "
              f"{N_TTFT} runs (min {min(ttfts):.2f}, max {max(ttfts):.2f}); decode "
              f"{decode_tps:.1f} tok/s (128 tokens, batch 1) on {card_note}", flush=True)
        ids = [f.token_ids for f in firsts] + [resp.token_ids, resumed.token_ids]
        return dict(ttft_ms=ttft_ms, ttft_ms_runs=ttfts, decode_tok_s=decode_tps,
                    decode_ms_per_token=resp.generate_time_ms / 128,
                    prefill_ms_512=resp.prompt_time_ms), launches, ids, graphs0

    e2e, launches, ids, graphs0 = drive(eng, "graphs")
    e2e["graphs"] = _graph_check("engine path", eng.graphs, graphs0, n_decode)
    e2e["eager"], _, eager_ids, _ = drive(eager, "eager")
    if eager_ids != ids:
        fail("engine path: the graphs' greedy ids differ from the eager run's")
    print(f"engine path: greedy ids of the graphs equal the eager run's ({len(ids)} requests, "
          f"{sum(map(len, ids))} tokens); eager decode {e2e['eager']['decode_tok_s']:.1f} tok/s, "
          f"TTFT {e2e['eager']['ttft_ms']:.2f} ms", flush=True)

    # the prefill logits of a short prompt against the plain path on the CPU
    toks = torch.tensor([prompt[:24]])
    pos = torch.arange(24)[None, :]
    gpu, _ = forward_logits(eng.params, cfg, toks.cuda(), pos.cuda(), None, dtype=torch.bfloat16)
    gpu = gpu.float().cpu()
    cpu_params = params_to(eng.params, "cpu")
    with torch.inference_mode():
        ref, _ = forward_logits(cpu_params, cfg, toks, pos, None, dtype=torch.float32)
    finite = bool(torch.isfinite(gpu).all())
    rel = ((gpu - ref).norm() / ref.norm()).item()
    print(f"prefill logits [1, 24, {cfg.vocab_size}] vs plain f32 on the CPU: rel L2 {rel:.3g}"
          f" (limit {LOGITS_REL_L2}), finite {finite}", flush=True)
    if not finite or not rel < LOGITS_REL_L2 or tuple(gpu.shape) != (1, 24, cfg.vocab_size):
        fail(f"logits check: rel L2 {rel}, finite {finite}, shape {tuple(gpu.shape)}")
    e2e.update(logits_rel_l2=rel,
               decode_logits_rel_l2=_dense_decode_logits_check(torch, eng.params, cfg,
                                                               prompt[:24]))
    return launches, e2e, (eng, eager, prompt)


def _dense_decode_logits_check(torch, params, cfg, ids) -> float:
    """The `Engine`'s dense decode on the card (a bf16 cache, bf16
    activations; K2 takes each step's attention) against the same weights on
    the CPU (dequantized once to f32, an f32 cache, the plain versions): a
    16-token prefill and 8 decode steps, relative L2 of the logits."""
    from jlama_tpu_torch.models.base import KVCache, forward_logits
    from jlama_tpu_torch.nn.qarray import QArray

    toks = torch.tensor([ids])
    pos = torch.arange(len(ids))[None, :]

    def run(params, device, dtype):
        cache = KVCache.init(cfg, 1, 64, dtype, device)
        with torch.inference_mode():
            outs = [forward_logits(params, cfg, toks[:, :16].to(device), pos[:, :16].to(device),
                                   cache, dtype=dtype)[0]]
            for t in range(16, len(ids)):
                outs.append(forward_logits(params, cfg, toks[:, t:t + 1].to(device),
                                           pos[:, t:t + 1].to(device), cache, dtype=dtype)[0])
        return torch.cat(outs, dim=1).float().cpu()

    def deq(v):
        if isinstance(v, list):
            return [deq(x) for x in v]
        if isinstance(v, dict):
            return {k: deq(x) for k, x in v.items()}
        return v.dequantize(torch.float32).cpu() if isinstance(v, QArray) else v.float().cpu()

    gpu = run(params, "cuda", torch.bfloat16)
    ref = run(deq(params), "cpu", torch.float32)
    finite = bool(torch.isfinite(gpu).all())
    rel = ((gpu - ref).norm() / ref.norm()).item()
    print(f"dense decode logits [1, {len(ids)}, {cfg.vocab_size}] (16-token prefill + "
          f"{len(ids) - 16} decode steps through K2, bf16 cache) vs plain f32 on the CPU: rel L2 "
          f"{rel:.3g} (limit {LOGITS_REL_L2}), finite {finite}", flush=True)
    if not finite or not rel < LOGITS_REL_L2 or tuple(gpu.shape) != (1, len(ids), cfg.vocab_size):
        fail(f"dense decode logits: rel L2 {rel}, finite {finite}, shape {tuple(gpu.shape)}")
    return rel


def profile_path(torch, eng, prompt, run) -> dict:
    """Device time by kernel and the device's busy share over two windows of
    the main path, with torch.profiler (whose own host cost lowers the busy
    share it reports, so the share is a lower bound). run: "graphs" or
    "eager", the engine's decode steps."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    _unfused_rope_calls(reset=True)
    # the profiled session takes the main session's cache slot, whose decode
    # graph the main path captured: the windows hold no capture
    eng.drop_session("main")
    for label, ids, n in (("prefill 511 + first token", prompt, 1),
                          ("decode 32 tokens", [], 32)):
        graphs0 = eng.graphs.stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate_tokens(ids, max_new_tokens=n, stop_ids=set(), session_id="prof")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if run == "graphs":
            _graph_check(f"profile {label}", eng.graphs, graphs0, n)
        kernels = []
        for e in prof.key_averages():
            if not str(e.device_type).endswith("CUDA"):
                continue
            kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
        kernels.sort(reverse=True)
        dev_ms = sum(k[0] for k in kernels)
        if dev_ms <= 0:
            fail(f"profile {label}: the profiler saw no device time")
        groups = {"q4_matmul": 0.0, "flash_prefill": 0.0, "paged_decode": 0.0, "kv_write": 0.0,
                  "other": 0.0}
        for ms, _, key in kernels:
            g = ("q4_matmul" if K1_NAMES.search(key) else
                 next((k for k in ("flash_prefill", "paged_decode", "kv_write") if k in key),
                      "other"))
            groups[g] += ms
        dense_attn = [key for _, _, key in kernels if DENSE_ATTN_NAMES.search(key)]
        if n > 1 and dense_attn:
            fail(f"profile {label}: the dense attention's library kernels ran: {dense_attn}")
        n_ops = sum(c for _, c, _ in kernels)
        if _unfused_rope_calls():
            fail(f"profile {label}: apply_rope ran {_unfused_rope_calls()} times on the card "
                 "apart from K4")
        out[label] = dict(wall_ms=wall_ms, device_ms=dev_ms, busy_share=dev_ms / wall_ms,
                          device_ops=n_ops, device_ops_per_token=n_ops / n, by_group_ms=groups,
                          top=[dict(ms=ms, count=c, kernel=key[:90]) for ms, c, key in kernels[:12]])
        print(f"profile ({run}) {label}: wall {wall_ms:.2f} ms (profiler on), device "
              f"{dev_ms:.2f} ms, busy share {dev_ms / wall_ms:.3f}, {n_ops} device ops "
              f"({n_ops / n:.1f} per "
              f"token); by group "
              + ", ".join(f"{g} {v:.2f} ms" for g, v in groups.items()), flush=True)
        for ms, c, key in kernels[:12]:
            print(f"  {ms:8.3f} ms {c:6d}x {key[:90]}")
    return out


def _count_unfused_rope() -> None:
    """Wrap `nn.layers.apply_rope`, the RoPE that runs apart from K4 (on the
    path without a cache), in a counter of its calls on the card. Phases 4-7
    drive only cached paths, where K4 rotates q and k: they must make none."""
    from jlama_tpu_torch.nn import layers

    inner = layers.apply_rope

    def apply_rope(x, cos, sin):
        apply_rope.calls += x.is_cuda
        return inner(x, cos, sin)

    apply_rope.calls = 0
    layers.apply_rope = apply_rope


def _unfused_rope_calls(reset: bool = False) -> int:
    from jlama_tpu_torch.nn import layers

    n = layers.apply_rope.calls
    if reset:
        layers.apply_rope.calls = 0
    return n


SERVE = dict(n_slots=16, n_pages=512, page_size=64, prefill_chunk=256, decode_lag=4,
             max_seq_len=2048)  # jlama_tpu/cli.py's serving defaults
KERNELS = ("q4_matmul", "paged_decode", "flash_prefill", "kv_write", "w8a8_matmul")


def _kernel_fns():
    from jlama_tpu_torch.ops.attention import flash_prefill, paged_decode
    from jlama_tpu_torch.ops.kv_write import kv_write
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul
    from jlama_tpu_torch.ops.w8a8 import q4s_matmul

    return {"q4_matmul": q4_matmul, "paged_decode": paged_decode,
            "flash_prefill": flash_prefill, "kv_write": kv_write, "w8a8_matmul": q4s_matmul}


def _reset_counts(sched):
    for fn in _kernel_fns().values():
        fn.launches = 0
    _unfused_rope_calls(reset=True)
    sched.n_prefill_calls = sched.n_decode_steps = 0


def _check_counts(sched, cfg, label, matmul="q4_matmul") -> dict:
    """The kernels' launches against the scheduler's own counts: a prefill
    call (T > 1) launches 4 matmuls (K1, or K5 for q4s weights), one K3 and
    one K4 per layer; a decode step 4 matmuls, one K2 and one K4 per layer,
    and the lm_head's matmul. The other matmul kernel launches no time."""
    got = {k: fn.launches for k, fn in _kernel_fns().items()}
    L, n_pf, n_dec = cfg.n_layers, sched.n_prefill_calls, sched.n_decode_steps
    other = "w8a8_matmul" if matmul == "q4_matmul" else "q4_matmul"
    expect = {matmul: n_pf * 4 * L + n_dec * (4 * L + 1), other: 0, "paged_decode": n_dec * L,
              "flash_prefill": n_pf * L, "kv_write": (n_pf + n_dec) * L}
    rope = _unfused_rope_calls()
    print(f"{label}: {n_pf} prefill calls, {n_dec} decode steps; launches {got}, "
          f"expected {expect}; apply_rope apart from K4 {rope} times (expected 0)", flush=True)
    if got != expect or min(v for k, v in got.items() if k != other) == 0:
        fail(f"{label}: launch counts {got} != expected {expect}")
    if rope:
        fail(f"{label}: apply_rope ran {rope} times on the card apart from K4")
    return dict(got, prefill_calls=n_pf, decode_steps=n_dec)


def _check_finish(reqs, cfg, label):
    from jlama_tpu_torch.runtime.engine import FinishReason

    for r in reqs:
        stops = r.stop_ids or set(cfg.eos_token_ids)
        n, ids = len(r.out_ids), r.out_ids
        if not all(0 <= t < cfg.vocab_size for t in ids) or any(t in stops for t in ids[:-1]):
            fail(f"{label}: request {r.id}: bad ids or a stop id before the end: {ids[:8]}...")
        if r.finish == FinishReason.MAX_TOKENS:
            ok = n == r.max_new_tokens and (not ids or ids[-1] not in stops)
        elif r.finish == FinishReason.STOP_TOKEN:
            ok = 1 <= n <= r.max_new_tokens and ids[-1] in stops
        else:
            ok = False
        if not ok:
            fail(f"{label}: request {r.id} ended {r.finish} with {n} of {r.max_new_tokens} "
                 f"tokens (error {r.error})")


def _wait(reqs, timeout_s, label):
    t0 = time.perf_counter()
    for r in reqs:
        if not r.done_event.wait(max(0.0, timeout_s - (time.perf_counter() - t0))):
            fail(f"{label}: requests not done after {timeout_s} s")


def _pct(xs, p):
    return statistics.quantiles(xs, n=100, method="inclusive")[p - 1] if len(xs) > 1 else xs[0]


def serving_path(torch, card_note):
    from jlama_tpu_torch.models.init import llama_1b_config, random_q4_params
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest

    cfg = llama_1b_config()
    V = cfg.vocab_size
    t0 = time.perf_counter()
    params = random_q4_params(cfg, seed=0, device="cuda")
    sched = BatchScheduler(params, cfg, kv_dtype=torch.bfloat16, device="cuda", **SERVE)
    pool_gb = 2 * sched.kv.state.k_pool.numel() * 2 / 1e9
    sched.warmup()
    torch.cuda.synchronize()
    warm = sched.graphs.stats()
    print(f"serving: Llama-3.2-1B, {SERVE}, bf16 pool {pool_gb:.3f} GB; set-up and warm-up "
          f"{time.perf_counter() - t0:.2f} s; warm-up captured {warm['graphs']} decode graphs "
          f"in {warm['capture_s']:.3f} s, pool {warm['pool_bytes'] / 2**20:.1f} MB", flush=True)

    g = torch.Generator().manual_seed(7)

    def rint(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=g))

    def ids(n):
        return torch.randint(0, V, (n,), generator=g).tolist()

    reqs = []
    for i in range(23):
        kw = dict(prompt_ids=ids(rint(32, 1024)), max_new_tokens=rint(64, 128))
        if i < 8:  # seeded draws
            kw.update(temperature=0.8, top_p=0.95, top_k=40, seed=100 + i)
        elif i == 8:  # a session, resumed below by a second request
            kw.update(prompt_ids=ids(200), session_id="chat")
        elif i == 9:  # forces depth-1 windows while it runs
            kw.update(frequency_penalty=0.5)
        elif i == 10:  # stop ids: half the vocabulary, drawn from, so it stops early
            kw.update(stop_ids=set(range(0, V, 2)), temperature=1.0, seed=5)
        reqs.append(GenRequest(**kw))
    follow = GenRequest(prompt_ids=ids(100), max_new_tokens=64, session_id="chat")

    _reset_counts(sched)
    graphs0 = sched.graphs.stats()
    t_start = time.perf_counter()
    sched.start()
    for r in reqs[:16]:
        sched.submit(r)
    # 8 more while the batch runs: once it has produced 16 tokens a slot,
    # and the session's second request once its first is done
    while sum(len(r.out_ids) for r in reqs[:16]) < 16 * 16:
        if time.perf_counter() - t_start > 300:
            fail("serving: no progress in 300 s")
        time.sleep(0.005)
    for r in reqs[16:]:
        sched.submit(r)
    _wait([reqs[8]], 300, "serving")
    sched.submit(follow)
    everything = reqs + [follow]
    _wait(everything, 300, "serving")
    wall = time.perf_counter() - t_start
    sched.stop()
    torch.cuda.synchronize()
    counts = _check_counts(sched, cfg, "serving path")
    graphs = _graph_check("serving path", sched.graphs, graphs0, counts["decode_steps"])
    _check_finish(everything, cfg, "serving")
    if reqs[10].finish.name != "STOP_TOKEN":
        fail(f"serving: the stop-id request ended {reqs[10].finish}")
    pos = sched.session_state.get("chat", (None,))[0]
    want = len(reqs[8].prompt_ids) + len(reqs[8].out_ids) + len(follow.prompt_ids) \
        + len(follow.out_ids) - 1
    if pos != want:
        fail(f"serving: resumed session at position {pos}, expected {want}")
    resps = [r.to_response() for r in everything]
    n_gen = sum(r.generated_tokens for r in resps)
    ttft = [r.prompt_time_ms for r in resps]
    itl = [r.generate_time_ms / (r.generated_tokens - 1) for r in resps if r.generated_tokens > 1]
    e2e = dict(requests=len(resps), generated_tokens=n_gen, wall_s=wall, tok_s=n_gen / wall,
               ttft_ms_p50=_pct(ttft, 50), ttft_ms_p95=_pct(ttft, 95),
               itl_ms_p50=_pct(itl, 50), itl_ms_p95=_pct(itl, 95),
               finish={f: sum(r.finish_reason.name == f for r in resps)
                       for f in ("MAX_TOKENS", "STOP_TOKEN")}, launches=counts,
               graphs=dict(graphs, warmup=warm))
    print(f"serving: {len(resps)} requests, {n_gen} tokens in {wall:.2f} s = "
          f"{n_gen / wall:.1f} tok/s; TTFT p50 {e2e['ttft_ms_p50']:.1f} ms, p95 "
          f"{e2e['ttft_ms_p95']:.1f} ms; inter-token p50 {e2e['itl_ms_p50']:.2f} ms, p95 "
          f"{e2e['itl_ms_p95']:.2f} ms; finishes {e2e['finish']} on {card_note}", flush=True)

    e2e["profile"] = _serving_profile(torch, sched, cfg, ids, "graphs")
    e2e["logits_rel_l2"] = {"bf16": _paged_logits_check(torch, sched, cfg, torch.bfloat16, ids)}
    params = sched.params
    eager = BatchScheduler(params, cfg, kv_dtype=torch.bfloat16, device="cuda", fuse=False,
                           decode_graphs=False, **SERVE)
    e2e["eager_ids"] = _eager_ids_check(sched, eager, ids, "serving")
    e2e["profile_eager"] = _serving_profile(torch, eager, cfg, ids, "eager")
    del sched, eager
    torch.cuda.empty_cache()

    # a short run on a q8 pool
    sq = BatchScheduler(params, cfg, kv_dtype="q8", device="cuda", fuse=False, **SERVE)
    q8reqs = [GenRequest(prompt_ids=ids(rint(100, 300)), max_new_tokens=32,
                         **({"temperature": 0.8, "seed": 3} if i == 0 else {}))
              for i in range(4)]
    _reset_counts(sq)
    graphs0 = sq.graphs.stats()
    sq.start()
    for r in q8reqs:
        sq.submit(r)
    _wait(q8reqs, 300, "q8 serving")
    sq.stop()
    torch.cuda.synchronize()
    e2e["q8_launches"] = _check_counts(sq, cfg, "q8 serving path")
    e2e["q8_graphs"] = _graph_check("q8 serving path", sq.graphs, graphs0,
                                    e2e["q8_launches"]["decode_steps"])
    _check_finish(q8reqs, cfg, "q8 serving")
    e2e["logits_rel_l2"]["q8"] = _paged_logits_check(torch, sq, cfg, "q8", ids)
    del sq
    return counts, e2e


def q4s_serving_path(torch, card_note, q4_serving):
    """Phase 7: W4A8 serving, BatchScheduler(weight_format="q4s")."""
    from jlama_tpu_torch.models.init import llama_1b_config, random_q4_params
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest

    cfg = llama_1b_config()
    V = cfg.vocab_size
    params = random_q4_params(cfg, seed=0, device="cuda")
    # the constructor, timed: fuse, to_q4s of every 2-D weight on the card, the pool
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = BatchScheduler(params, cfg, weight_format="q4s", kv_dtype=torch.bfloat16,
                           device="cuda", **SERVE)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    del params
    q4s = [sched.params["lm_head"]] + [w for layer in sched.params["layers"]
                                       for w in layer.values() if getattr(w, "fmt", "") == "q4s"]
    q4s_gb = sum(w.data.nbytes + sum(t.nbytes for t in w.scales) for w in q4s) / 1e9
    t0 = time.perf_counter()
    sched.warmup()
    torch.cuda.synchronize()
    warm = sched.graphs.stats()
    print(f"q4s serving: Llama-3.2-1B, {SERVE}; BatchScheduler(weight_format='q4s') "
          f"construction (fuse + to_q4s on the card + pool) {conv_s:.3f} s, {len(q4s)} q4s "
          f"weights {q4s_gb:.3f} GB; warm-up {time.perf_counter() - t0:.2f} s, "
          f"{warm['graphs']} decode graphs captured in {warm['capture_s']:.3f} s, pool "
          f"{warm['pool_bytes'] / 2**20:.1f} MB", flush=True)

    g = torch.Generator().manual_seed(8)

    def rint(lo, hi):
        return int(torch.randint(lo, hi + 1, (1,), generator=g))

    def ids(n):
        return torch.randint(0, V, (n,), generator=g).tolist()

    reqs = []
    for i in range(12):
        kw = dict(prompt_ids=ids(rint(32, 1024)), max_new_tokens=rint(64, 128))
        if i < 4:  # seeded draws
            kw.update(temperature=0.8, top_p=0.95, top_k=40, seed=200 + i)
        reqs.append(GenRequest(**kw))
    _reset_counts(sched)
    graphs0 = sched.graphs.stats()
    t_start = time.perf_counter()
    sched.start()
    for r in reqs[:8]:
        sched.submit(r)
    # 4 more while the batch runs: once it has produced 16 tokens a slot
    while sum(len(r.out_ids) for r in reqs[:8]) < 8 * 16:
        if time.perf_counter() - t_start > 300:
            fail("q4s serving: no progress in 300 s")
        time.sleep(0.005)
    for r in reqs[8:]:
        sched.submit(r)
    _wait(reqs, 300, "q4s serving")
    wall = time.perf_counter() - t_start
    sched.stop()
    torch.cuda.synchronize()
    counts = _check_counts(sched, cfg, "q4s serving path", matmul="w8a8_matmul")
    graphs = _graph_check("q4s serving path", sched.graphs, graphs0, counts["decode_steps"])
    _check_finish(reqs, cfg, "q4s serving")
    resps = [r.to_response() for r in reqs]
    n_gen = sum(r.generated_tokens for r in resps)
    ttft = [r.prompt_time_ms for r in resps]
    itl = [r.generate_time_ms / (r.generated_tokens - 1) for r in resps if r.generated_tokens > 1]
    e2e = dict(requests=len(resps), generated_tokens=n_gen, wall_s=wall, tok_s=n_gen / wall,
               ttft_ms_p50=_pct(ttft, 50), ttft_ms_p95=_pct(ttft, 95),
               itl_ms_p50=_pct(itl, 50), itl_ms_p95=_pct(itl, 95),
               finish={f: sum(r.finish_reason.name == f for r in resps)
                       for f in ("MAX_TOKENS", "STOP_TOKEN")}, launches=counts,
               construction_s=conv_s, q4s_weights_gb=q4s_gb, graphs=dict(graphs, warmup=warm))
    e2e["profile"] = _serving_profile(torch, sched, cfg, ids, "graphs")
    e2e["logits_rel_l2"] = _paged_logits_check(torch, sched, cfg, torch.bfloat16, ids)
    # the eager yardstick on the same q4s weights (already converted: no format)
    eager = BatchScheduler(sched.params, cfg, kv_dtype=torch.bfloat16, device="cuda",
                           fuse=False, decode_graphs=False, **SERVE)
    e2e["eager_ids"] = _eager_ids_check(sched, eager, ids, "q4s serving")
    e2e["profile_eager"] = _serving_profile(torch, eager, cfg, ids, "eager")
    del eager
    q4 = q4_serving
    print(f"q4s serving: {len(resps)} requests, {n_gen} tokens in {wall:.2f} s = "
          f"{n_gen / wall:.1f} tok/s (phase 6, q4, 24 requests: {q4['tok_s']:.1f}); TTFT p50 "
          f"{e2e['ttft_ms_p50']:.1f} ms (q4 {q4['ttft_ms_p50']:.1f}), p95 "
          f"{e2e['ttft_ms_p95']:.1f} ms (q4 {q4['ttft_ms_p95']:.1f}); inter-token p50 "
          f"{e2e['itl_ms_p50']:.2f} ms (q4 {q4['itl_ms_p50']:.2f}), p95 {e2e['itl_ms_p95']:.2f} ms "
          f"(q4 {q4['itl_ms_p95']:.2f}); busy share over 16 decode steps "
          f"{e2e['profile']['busy_share']:.3f} (q4 {q4['profile']['busy_share']:.3f}; eager "
          f"{e2e['profile_eager']['busy_share']:.3f}, q4 "
          f"{q4['profile_eager']['busy_share']:.3f}); finishes "
          f"{e2e['finish']} on {card_note}", flush=True)
    del sched
    torch.cuda.empty_cache()
    return counts, e2e


def ppl_path(torch) -> dict:
    """Phase 8: eval.ppl.score_tokens on the card with the q4 weights and
    their q4s conversion. Random weights: the level means nothing, so only
    the relative delta and the kernels' launches are reported."""
    from jlama_tpu_torch.eval.ppl import score_tokens
    from jlama_tpu_torch.models.init import llama_1b_config, random_q4_params
    from jlama_tpu_torch.ops.w8a8 import prepare_params_for_w8a8

    cfg = llama_1b_config()
    params = random_q4_params(cfg, seed=0, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (PPL_TOKENS,),
                        generator=torch.Generator().manual_seed(9)).numpy()
    n_win = 1 + (PPL_TOKENS - PPL_SEQ) // PPL_STRIDE
    fns = _kernel_fns()
    out = {}
    for fmt, p in (("q4", params), ("q4s", prepare_params_for_w8a8(params))):
        for fn in fns.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppl = score_tokens(p, cfg, ids, seq_len=PPL_SEQ, stride=PPL_STRIDE, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: fns[k].launches for k in ("q4_matmul", "w8a8_matmul", "flash_prefill")}
        # unfused weights: 7 projections per layer, and the lm_head, per window
        mm = n_win * (7 * cfg.n_layers + 1)
        expect = {"q4_matmul": mm if fmt == "q4" else 0, "w8a8_matmul": mm if fmt == "q4s" else 0,
                  "flash_prefill": n_win * cfg.n_layers}
        print(f"perplexity ({fmt}): {ppl:.6g} over {PPL_TOKENS} random ids, windows of "
              f"{PPL_SEQ} stride {PPL_STRIDE} ({n_win} windows, f32 activations) in "
              f"{secs:.2f} s; launches {got}, expected {expect}", flush=True)
        if not math.isfinite(ppl) or got != expect:
            fail(f"perplexity ({fmt}): {ppl}, launches {got} != {expect}")
        out[fmt] = dict(ppl=ppl, seconds=secs, launches=got)
    delta = (out["q4s"]["ppl"] - out["q4"]["ppl"]) / out["q4"]["ppl"]
    print(f"perplexity: q4s against q4, relative delta {delta:.3g} (random weights: the "
          "levels mean nothing)", flush=True)
    out["relative_delta"] = delta
    return out


def _eager_ids_check(sched, eager, ids, label) -> dict:
    """16 greedy requests (prompts of 32-400 tokens, 48 new each), driven
    inline by step() through the scheduler's decode graphs and through the
    eager yardstick: the ids must be identical."""
    from jlama_tpu_torch.runtime.scheduler import GenRequest, RequestState

    prompts = [ids(32 + 23 * i) for i in range(16)]
    got = {}
    for run, s in (("graphs", sched), ("eager", eager)):
        reqs = [GenRequest(prompt_ids=p, max_new_tokens=48) for p in prompts]
        graphs0, n0 = s.graphs.stats(), s.n_decode_steps
        for r in reqs:
            s.submit(r)
        while not all(r.state == RequestState.DONE for r in reqs):
            s.step()
        if run == "graphs":
            _graph_check(f"{label} greedy check", s.graphs, graphs0, s.n_decode_steps - n0)
        got[run] = [r.out_ids for r in reqs]
    same = got["graphs"] == got["eager"]
    print(f"{label}: greedy ids of 16 requests x 48 tokens through the decode graphs "
          f"{'equal' if same else 'DIFFER FROM'} the eager run's", flush=True)
    if not same or any(len(x) != 48 for x in got["graphs"]):
        fail(f"{label}: the graphs' greedy ids differ from the eager run's")
    return dict(requests=16, tokens=16 * 48, equal=same)


def _serving_profile(torch, sched, cfg, ids, run) -> dict:
    """The device's busy share over 16 decode steps at 16 slots (chained
    windows of 4), with torch.profiler (whose own host cost lowers the busy
    share it reports: a lower bound). run: "graphs" or "eager", the
    scheduler's decode steps."""
    from torch.profiler import ProfilerActivity, profile

    from jlama_tpu_torch.runtime.scheduler import GenRequest, RequestState

    reqs = [GenRequest(prompt_ids=ids(64), max_new_tokens=64) for _ in range(16)]
    for r in reqs:
        sched.submit(r)
    while not all(r.state == RequestState.RUNNING and r.out_ids for r in reqs):
        sched.step()
    torch.cuda.synchronize()
    _unfused_rope_calls(reset=True)
    graphs0 = sched.graphs.stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n0 = sched.n_decode_steps
        while sched.n_decode_steps - n0 < 16:
            sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        n_steps = sched.n_decode_steps - n0
    if run == "graphs":
        _graph_check("serving profile", sched.graphs, graphs0, n_steps)
    while not all(r.state == RequestState.DONE for r in reqs):
        sched.step()
    groups = {"q4_matmul": 0.0, "w8a8_matmul": 0.0, "paged_decode": 0.0, "kv_write": 0.0,
              "other": 0.0}
    kernels = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    dev_ms = sum(k[0] for k in kernels)
    if dev_ms <= 0:
        fail("serving profile: the profiler saw no device time")
    k5 = {}  # K5's device kernels by name: the decode kernel, the pre-pass, the wgmma kernel
    for ms, c, key in kernels:
        grp = ("q4_matmul" if K1_NAMES.search(key) else "w8a8_matmul" if K5_NAMES.search(key)
               else "paged_decode" if "paged_decode" in key
               else "kv_write" if "kv_write" in key else "other")
        groups[grp] += ms
        if grp == "w8a8_matmul":
            name = K5_NAMES.search(key).group(0)
            k5[name] = dict(ms=k5.get(name, {}).get("ms", 0.0) + ms,
                            count=k5.get(name, {}).get("count", 0) + c)
    n_ops = sum(c for _, c, _ in kernels)
    if _unfused_rope_calls():
        fail(f"serving profile: apply_rope ran {_unfused_rope_calls()} times on the card apart "
             "from K4")
    print(f"profile ({run}) serving decode, {n_steps} steps at 16 slots: wall {wall_ms:.2f} ms "
          f"(profiler on), device {dev_ms:.2f} ms, busy share {dev_ms / wall_ms:.3f}, "
          f"{n_ops} device ops ({n_ops / n_steps:.1f} per step, {n_ops / n_steps / 16:.1f} per "
          f"token); by group "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items()), flush=True)
    for ms, c, key in kernels[:12]:
        print(f"  {ms:8.3f} ms {c:6d}x {key[:90]}")
    if k5:
        print("  K5 by kernel: " + ", ".join(f"{k} {v['ms']:.2f} ms ({v['count']}x)"
                                           for k, v in k5.items()), flush=True)
    return dict(steps=n_steps, wall_ms=wall_ms, device_ms=dev_ms, busy_share=dev_ms / wall_ms,
                device_ops=n_ops, device_ops_per_step=n_ops / n_steps, by_group_ms=groups,
                k5_kernels=k5,
                top=[dict(ms=ms, count=c, kernel=key[:90]) for ms, c, key in kernels[:12]])


def _paged_logits_check(torch, sched, cfg, kv_dtype, ids) -> float:
    """The paged forward's logits on the card (bf16 activations, K1-K5)
    against the same weights and the same pool kind on the CPU (plain
    versions, f32 activations): q4 and q8 weights dequantized once to f32,
    q4s weights as they are, through K5's plain version (int8 activations
    included); a 24-token prefill and 8 decode steps."""
    from jlama_tpu_torch.kv.paged import PagedKVCache
    from jlama_tpu_torch.models.base import forward_logits
    from jlama_tpu_torch.nn.qarray import QArray

    toks = torch.tensor([ids(32)])
    pos = torch.arange(32)[None, :]

    def run(params, device, dtype):
        kv = PagedKVCache(cfg, n_pages=4, page_size=64, max_pages_per_seq=2, dtype=kv_dtype,
                          device=device)
        kv.alloc.ensure_capacity("s", 32, 64)
        pt = torch.from_numpy(kv.page_table(["s"])).to(device)
        cache = (kv.layer_states(), pt)
        outs = []
        with torch.inference_mode():
            lg, _ = forward_logits(params, cfg, toks[:, :24].to(device), pos[:, :24].to(device),
                                   cache, dtype=dtype)
            outs.append(lg)
            for t in range(24, 32):
                lg, _ = forward_logits(params, cfg, toks[:, t:t + 1].to(device),
                                       pos[:, t:t + 1].to(device), cache, dtype=dtype)
                outs.append(lg)
        return torch.cat(outs, dim=1).float().cpu()

    gpu = run(sched.params, "cuda", torch.bfloat16)

    def deq(v):
        if isinstance(v, list):
            return [deq(x) for x in v]
        if isinstance(v, dict):
            return {k: deq(x) for k, x in v.items()}
        if isinstance(v, QArray):
            return v.to("cpu") if v.fmt == "q4s" else v.dequantize(torch.float32).cpu()
        return v.float().cpu()

    ref = run(deq(sched.params), "cpu", torch.float32)
    finite = bool(torch.isfinite(gpu).all())
    rel = ((gpu - ref).norm() / ref.norm()).item()
    print(f"paged logits [1, 32, {cfg.vocab_size}] ({kv_dtype} pool; 24-token prefill + 8 "
          f"decode steps) vs plain f32 on the CPU: rel L2 {rel:.3g} (limit {LOGITS_REL_L2}), "
          f"finite {finite}", flush=True)
    if not finite or not rel < LOGITS_REL_L2 or tuple(gpu.shape) != (1, 32, cfg.vocab_size):
        fail(f"paged logits ({kv_dtype}): rel L2 {rel}, finite {finite}, shape {tuple(gpu.shape)}")
    return rel


def _bench_line(r) -> str:
    """One compact line per (variant, shape, M)."""
    head = f"{r['bench']:15s} {r['variant']:17s} {r['N']:>6d}x{r['K']:<5d} M={r['M']:<2d}"
    if r["kind"] != "variant":
        return f"{head} {r['ms']:.4f} ms ({r['kind']})"
    line = (f"{head} {r['ms']:.4f} ms plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} "
            f"({100 * r['bound_share']:.1f}%) {r['bytes'] / 1e6:.2f} MB")
    if r.get("gbps_q4"):
        line += f" {r['gbps_q4']:.1f} GB/s(q4)"
    line += f" err {r['max_abs_err']:.3g} ({r['limit_ratio']:.2f} of limit)"
    if r.get("wrong"):
        line += f" WRONG({r['rel_err_exact']:.1e})"
    return line


def design_benches(torch) -> dict:
    """Phase 9: the TPU design benches P1-P3 as card benches. Each port
    module's run() on the card: kbench_q4's variants at Llama-3.2-1B's four
    (N, K) and Llama-3.1-8B's two (w1/w3, w2), and kbench_w8a8's at the JAX
    bench's two shapes, at M = 1 and 16; the probes at their own shapes. Every kernel is held against its plain version
    (limit_ratio <= 1) and each wrapper must have launched."""
    from jlama_tpu_torch.scripts import (
        _common, kbench_q4, kbench_w8a8, probe_int4, probe_sigma_i16)
    from jlama_tpu_torch.utils.cuda_timer import Timer

    mods = {"kbench_q4": kbench_q4, "kbench_w8a8": kbench_w8a8, "probe_int4": probe_int4,
            "probe_sigma_i16": probe_sigma_i16}
    print(f"design benches: each kernel within {_common.BF16_REL} |plain| + "
          f"{_common.F32_REORDER} max|plain| of its plain version (di8, di8b and the sigma "
          "probes: equal); WRONG(rel): the variant's own function misses the exact "
          "product by more than the JAX bench's limit", flush=True)
    q4_shapes = kbench_q4.SHAPES_1B + kbench_q4.SHAPES_8B
    t0 = time.perf_counter()
    timer = Timer()
    for mod in mods.values():
        for w in mod.WRAPPERS:
            w.launches = 0
    runs = []
    for m in (1, 16):
        runs.append(("kbench_q4", kbench_q4.run(list(kbench_q4.VARIANTS), q4_shapes, m, "cuda",
                                                timer=timer)))
        runs.append(("kbench_w8a8", kbench_w8a8.run(list(kbench_w8a8.VARIANTS),
                                                    kbench_w8a8.SHAPES, m, "cuda", timer=timer)))
    runs.append(("probe_int4", probe_int4.run(["xla", "pallas", "bitcast"], "cuda", timer=timer)))
    runs.append(("probe_sigma_i16", probe_sigma_i16.run(list(probe_sigma_i16.PROBES), "cuda",
                                                        timer=timer)))
    torch.cuda.synchronize()
    launches = {f"{b}.{w.__name__}": w.launches for b, mod in mods.items() for w in mod.WRAPPERS}
    secs = time.perf_counter() - t0
    rows = [dict(r, bench=b) for b, rs in runs for r in rs]
    for r in rows:
        print(_bench_line(r), flush=True)
    bad = [r for r in rows if r["kind"] == "variant" and not r["limit_ratio"] <= 1.0]
    if bad:
        fail("design benches: kernels outside their limit against the plain version: "
             + "; ".join(_bench_line(r) for r in bad[:5]))
    if min(launches.values()) == 0:
        fail(f"design benches: a kernel never launched: {launches}")
    print(f"design benches: {len(rows)} rows in {secs:.1f} s; launches {launches}", flush=True)

    def at(bench, variant, n, k, m):
        return next(r for r in rows if (r["bench"], r["variant"], r["N"], r["K"], r["M"])
                    == (bench, variant, n, k, m))

    n, k, m = BENCH_MAIN
    lib = {"kbench_q4": at("kbench_q4", "torch.matmul bf16", n, k, m),
           "kbench_w8a8": at("kbench_q4", "torch.matmul bf16", n, k, m)}
    p4, ps = probe_int4, probe_sigma_i16
    lib["probe_int4"] = at("probe_int4", "torch.matmul bf16", p4.N, p4.K, p4.M)
    lib["probe_sigma_i16"] = at("probe_sigma_i16", "torch.matmul f32", ps.N, ps.K, 1)
    # (bench, wrapper, the variant whose row the kernels line reports)
    bodies = [("kbench_q4", v, v) for v in ("v3a", "v3b", "v4", "v7", "v8", "v8b", "v9", "v11",
                                            "dot2", "di8", "stream")]
    bodies += [("kbench_w8a8", "pb8", "pb8"), ("kbench_w8a8", "pgb", "pgb8"),
               ("kbench_w8a8", "di8b", "di8b"), ("kbench_w8a8", "pk4", "pk4"),
               ("probe_int4", "u4_convert", "pallas"), ("probe_int4", "u4_bitcast", "bitcast")]
    bodies += [("probe_sigma_i16", w.__name__, name) for name, w in ps.PROBES.items()]
    kernels = []
    for bench, body, variant in bodies:
        main = (at(bench, variant, n, k, m) if bench in ("kbench_q4", "kbench_w8a8") else
                next(r for r in rows if r["bench"] == bench and r["variant"] == variant))
        mine = [r for r in rows if r["bench"] == bench and r.get("body") == body
                and r["kind"] == "variant"]
        kernels.append(dict(
            name=f"{bench}.{body}", route="cuda", source=f"jlama_tpu_torch/csrc/{bench}.cu",
            replaces=mods[bench].REPLACES[body], launches=launches[f"{bench}.{body}"],
            max_abs_err=max(r["max_abs_err"] for r in mine), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=lib[bench]["ms"],
            work=f"{variant} at N={main['N']}, K={main['K']}, M={main['M']}; library_ms: "
                 f"{lib[bench]['variant']} at that shape"))
    return dict(rows=rows, kernels=kernels, seconds=secs, launches=launches)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write per-shape details as JSON here")
    args = ap.parse_args()

    root = Path(__file__).resolve().parent
    if not (root / "jlama_tpu_torch" / "csrc").is_dir():
        fail("the jlama_tpu_torch package is not beside this script")
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # 2. build
    from jlama_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})", flush=True)
    for src in _build.SOURCES:
        log = _build.BUILD_DIR / f"{src}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {src}: {line.strip()}")

    details: list[dict] = []
    out = {"card": smi, "shapes": details}
    # 3. kernels against their plain versions
    from jlama_tpu_torch.utils.cuda_timer import BF16_OPS_PER_S, HBM_BYTES_PER_S, Timer

    timer = Timer()
    print(f"bound = max(bytes / {HBM_BYTES_PER_S / 1e12:.2f} TB/s, operations / "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16): the H100 SXM data-sheet peaks at "
          "700 W (a PCIe card or a lower power limit has lower peaks)", flush=True)
    kern = {"q4_matmul": check_k1(torch, timer, details),
            "paged_decode": check_k2(torch, timer, details),
            "flash_prefill": check_k3(torch, timer, details),
            "kv_write": check_k4(torch, timer, details),
            "w8a8_matmul": check_k5(torch, timer, details)}
    del timer
    # 4. and 5. the Engine path and where its time goes
    _count_unfused_rope()
    engine_launches, e2e, (eng, eager, prompt) = main_path(torch, smi)
    out["engine"] = e2e
    out["profile"] = profile_path(torch, eng, prompt, "graphs")
    out["profile_eager"] = profile_path(torch, eager, prompt, "eager")
    kern["q4_matmul"]["profile_decode32_ms"] = \
        out["profile"]["decode 32 tokens"]["by_group_ms"]["q4_matmul"]
    del eng, eager
    torch.cuda.empty_cache()
    print(f"card {smi}: engine " + json.dumps(e2e), flush=True)
    # 6. serving
    serving_launches, serving = serving_path(torch, smi)
    out["serving"] = serving
    print(f"card {smi}: serving " + json.dumps(
        {k: v for k, v in serving.items() if k != "profile"}), flush=True)
    # 7. q4s serving
    q4s_launches, q4s_serving = q4s_serving_path(torch, smi, serving)
    out["q4s_serving"] = q4s_serving
    print(f"card {smi}: q4s serving " + json.dumps(
        {k: v for k, v in q4s_serving.items() if k != "profile"}), flush=True)
    # 8. perplexity
    out["perplexity"] = ppl_path(torch)
    # 9. design benches
    benches = design_benches(torch)
    out["design_benches"] = dict(rows=benches["rows"], seconds=benches["seconds"],
                                 launches=benches["launches"])

    routes = {
        "q4_matmul": ("jlama_tpu_torch/csrc/q4_matmul.cu", "jlama_tpu/ops/pallas_q4.py:113"),
        "paged_decode": ("jlama_tpu_torch/csrc/paged_decode.cu",
                         "jlama_tpu/ops/pallas_attention.py:190"),
        "flash_prefill": ("jlama_tpu_torch/csrc/flash_prefill.cu",
                          "jlama_tpu/ops/pallas_attention.py:41"),
        "kv_write": ("jlama_tpu_torch/csrc/kv_write.cu", "jlama_tpu/ops/pallas_kv.py:27"),
        "w8a8_matmul": ("jlama_tpu_torch/csrc/w8a8_matmul.cu",
                        "jlama_tpu/ops/pallas_w8a8.py:176"),
    }
    kernels = []
    for k in KERNELS:
        src, rep = routes[k]
        if k == "w8a8_matmul":  # its path: q4s serving (phase 7)
            launches = dict(launches=q4s_launches[k], launches_engine=None,
                            launches_ppl=out["perplexity"]["q4s"]["launches"][k])
        else:
            launches = dict(launches=serving_launches.get(k),
                            launches_engine=engine_launches.get(k))
        row = dict(name=k, route="cuda", source=src, replaces=rep, **launches)
        row.update(kern[k])
        kernels.append(row)
    kernels += benches["kernels"]
    out["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
