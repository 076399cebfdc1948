#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jlama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE]

Phases, each fatal on failure (exit code 1, no result line):
  1. card   - the GPU's name, and its name and power limit from nvidia-smi;
  2. build  - nvcc builds every kernel of the path from csrc/, in parallel;
  3. kernels - each kernel against its plain PyTorch version on the card at
              the main path's shapes (Llama-3.2-1B, plus Llama-3.1-8B's w2
              and ragged edges), with its time, the plain version's time,
              a library yardstick's time (never used by the port) and the
              bound: max(bytes / 3.35 TB/s, operations / 989 TFLOP/s bf16),
              the H100 SXM data-sheet peaks;
  4. main path - Llama-3.2-1B at full width (16 layers, random JQ4 weights
              from a seed) through Engine.generate_tokens: a 512-token
              prompt with 128 new tokens, a resume of that session, and
              five time-to-first-token runs; the kernels' launch counters must
              match the path's expected counts; then the prefill logits of a
              short prompt are held against the same weights run through
              the plain path on the CPU (relative L2 error < 5e-2, bf16
              activations on the card against f32 on the CPU);
  5. profile - torch.profiler's device time by kernel, device operations
              and the device's busy share for a 512-token prefill and for 32
              decode steps of the main path.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. --out also writes the per-shape details and
the profile as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
K1_TOL = 2e-2  # max |kernel - plain| <= K1_TOL * max |plain| (bf16 W tiles / bf16 out)
K1_REL_L2 = 1e-2
K3_TOL = 2e-2  # max |kernel - plain| on N(0, 1) inputs (bf16 in and out)
LOGITS_REL_L2 = 5e-2
N_TTFT = 5  # time-to-first-token runs; the median is reported
SLEEP_CYCLES = 100_000_000  # ~50 ms at H100 clocks: the host queues every timed launch


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Timer:
    """Median device ms of a call, each launch after an L2 flush (the main path
    finds its weights cold: a decode step streams ~0.65 GB between two uses).
    The flush reads a 128 MB buffer: a write would leave the L2 full of dirty
    lines whose write-back the timed launch would pay for. A device-side
    sleep ahead of the timed launches lets the host enqueue all of them
    first, so the events time the device's work and not the wrapper's host
    cost between two events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
        # a quarter second of load first, so the first timed call does not
        # pay for the clocks ramping up from idle
        a = torch.randn((4096, 4096), device="cuda", dtype=torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.25:
            for _ in range(50):
                a @ a
            torch.cuda.synchronize()

    def __call__(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
        torch.cuda._sleep(SLEEP_CYCLES)
        for s, e in ev:
            self.flush.sum()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def check_k1(torch, timer, details):
    from jlama_tpu_torch.models.init import llama_1b_config, llama_8b_config
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain

    c1, c8 = llama_1b_config(), llama_8b_config()
    D, Hf, V = c1.embedding_length, c1.hidden_length, c1.vocab_size
    qkv = (c1.n_heads + 2 * c1.n_kv_heads) * c1.head_size
    layer_shapes = {"wqkv": (qkv, D), "wo": (D, D), "w13": (2 * Hf, D), "w2": (D, Hf)}
    cases = [(name, n, k, m, torch.bfloat16)
             for m in (1, 16, 512) for name, (n, k) in layer_shapes.items()]
    cases += [("lm_head", V, D, m, torch.float32) for m in (1, 16, 512)]
    cases += [("8b_w2", c8.embedding_length, c8.hidden_length, m, torch.bfloat16)
              for m in (1, 16, 512)]
    cases += [("uneven_n", 1000, 2048, m, torch.bfloat16) for m in (1, 37)]
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    per_shape = {}
    for name, n, k, m, out_dtype in cases:
        w = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device="cuda",
                                 dtype=torch.uint8),
                   (torch.rand((n, k // 32), generator=g, device="cuda") + 0.5) * 0.0043)
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        got = q4_matmul(x, w, out_dtype).float()
        ref = q4_matmul_plain(x, w.data, w.scales, torch.float32)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        rel = ((got - ref).norm() / ref.norm()).item()
        if not (err <= K1_TOL * scale and rel <= K1_REL_L2):
            fail(f"K1 {name} M={m} N={n} K={k}: max_abs_err {err} (max|ref| {scale}), "
                 f"rel L2 {rel}")
        worst = max(worst, err)
        wd = w.dequantize(torch.bfloat16)
        ms = timer(lambda: q4_matmul(x, w, out_dtype))
        plain_ms = timer(lambda: q4_matmul_plain(x, w.data, w.scales, out_dtype))
        lib_ms = timer(lambda: torch.matmul(x, wd.t()))
        del wd
        out_size = 4 if out_dtype == torch.float32 else 2
        nbytes = m * k * 2 + n * k // 2 + n * k // 32 * 4 + m * n * out_size
        b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
        row = dict(kernel="q4_matmul", shape=name, M=m, N=n, K=k, max_abs_err=err,
                   rel_l2=rel, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        details.append(row)
        per_shape[(name, m)] = row
        print(f"K1 {name:8s} M={m:4d} N={n:6d} K={k:5d}: {ms:.4f} ms (plain {plain_ms:.4f},"
              f" torch.matmul bf16 {lib_ms:.4f}, bound {b_ms:.4f} by {b_by}) err {err:.3g}",
              flush=True)
    # the JSON line's K1 work: one decode step of the main path (M = 1):
    # 16 layers x (wqkv, wo, w13, w2) + the lm_head
    L = c1.n_layers
    step = [per_shape[(s, 1)] for s in layer_shapes for _ in range(L)] + [per_shape[("lm_head", 1)]]
    summed = {key: sum(r[key] for r in step) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(summed, max_abs_err=worst, bound_by="bytes", work="one decode step, M=1: "
                f"{L} x (wqkv, wo, w13, w2) + lm_head = {len(step)} launches")


def check_k3(torch, timer, details):
    import torch.nn.functional as F

    from jlama_tpu_torch.ops.attention import flash_prefill, flash_prefill_plain

    H, n_kv = 32, 8
    cases = [  # (B, T, S, pos0, hd, softcap, window)
        (1, 512, 512, 0, 64, None, None),  # the main path's 512-token prefill
        (1, 512, 1024, 512, 64, None, None),
        (1, 512, 1024, 300, 64, None, None),
        (1, 512, 512, 0, 128, None, None),
        (1, 512, 1024, 512, 128, None, None),
        (2, 512, 1024, 400, 128, 30.0, 256),  # softcap + window
        (1, 200, 333, 100, 64, None, None),  # ragged T and S
    ]
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    main = None
    for B, T, S, p0, hd, cap, win in cases:
        q = torch.randn((B, H, T, hd), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((B, n_kv, S, hd), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((B, n_kv, S, hd), generator=g, device="cuda").to(torch.bfloat16)
        pos0 = torch.full((B,), p0, dtype=torch.int32, device="cuda")
        scale = hd ** -0.5
        got = flash_prefill(q, k, v, pos0, scale, softcap=cap, window=win).float()
        ref = flash_prefill_plain(q, k, v, pos0, scale, softcap=cap, window=win).float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        if not err <= K3_TOL:
            fail(f"K3 B={B} T={T} S={S} pos0={p0} hd={hd}: max_abs_err {err}")
        worst = max(worst, err)
        ms = timer(lambda: flash_prefill(q, k, v, pos0, scale, softcap=cap, window=win))
        plain_ms = timer(lambda: flash_prefill_plain(q, k, v, pos0, scale, softcap=cap,
                                                     window=win))
        qp = p0 + torch.arange(T, device="cuda")[:, None]
        kp = torch.arange(S, device="cuda")[None, :]
        mask = kp <= qp
        if win is not None:
            mask &= kp > qp - win
        live_pairs = int(mask.sum().item()) * B * H
        lib_ms = None
        if cap is None:  # SDPA has no softcap
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale, enable_gqa=True))
        nbytes = 2 * (2 * B * H * T * hd + 2 * B * n_kv * S * hd)
        b_ms, b_by = bound(nbytes, 4.0 * hd * live_pairs)
        row = dict(kernel="flash_prefill", B=B, H=H, n_kv=n_kv, T=T, S=S, pos0=p0, hd=hd,
                   softcap=cap, window=win, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        details.append(row)
        main = main or row
        print(f"K3 B={B} T={T} S={S:5d} pos0={p0:4d} hd={hd:3d} cap={cap} win={win}: "
              f"{ms:.4f} ms (plain {plain_ms:.4f}, sdpa {lib_ms}, bound {b_ms:.4f} by {b_by})"
              f" err {err:.3g}", flush=True)
    L = 16
    return dict(ms=main["ms"] * L, plain_ms=main["plain_ms"] * L,
                library_ms=main["library_ms"] * L, bound_ms=main["bound_ms"] * L,
                bound_by=main["bound_by"], max_abs_err=worst,
                work=f"one 512-token prefill of the main path: {L} launches at B=1, H=32, "
                     "n_kv=8, T=S=512, pos0=0, hd=64")


def main_path(torch, card_note):
    from jlama_tpu_torch.models.base import forward_logits, params_to
    from jlama_tpu_torch.models.init import llama_1b_config, random_q4_params
    from jlama_tpu_torch.ops.attention import flash_prefill
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul
    from jlama_tpu_torch.runtime.engine import Engine

    cfg = llama_1b_config()
    t0 = time.perf_counter()
    eng = Engine(random_q4_params(cfg, seed=0, device="cuda"), cfg, device="cuda",
                 max_seq_len=2048)
    torch.cuda.synchronize()
    print(f"main path: Llama-3.2-1B shapes, {cfg.n_layers} layers, random JQ4 weights "
          f"(seed 0), set-up {time.perf_counter() - t0:.2f} s", flush=True)
    rng = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()
    more = torch.randint(0, cfg.vocab_size, (64,), generator=rng).tolist()
    # a warm-up at the timed shapes (prefill bucket 512, decode window 1024),
    # so that the TTFT holds no first-use cost of the allocator or cuBLAS
    eng.generate_tokens(prompt, max_new_tokens=2, stop_ids=set(), session_id="warm")
    eng.drop_session("warm")
    torch.cuda.synchronize()

    q4_matmul.launches = 0
    flash_prefill.launches = 0
    ttfts, firsts = [], []
    for i in range(N_TTFT):  # each a new session: prefill + first token
        t1 = time.perf_counter()
        firsts.append(eng.generate_tokens(prompt, max_new_tokens=1, stop_ids=set(),
                                          session_id=f"ttft{i}"))
        torch.cuda.synchronize()
        ttfts.append((time.perf_counter() - t1) * 1000)
        eng.drop_session(f"ttft{i}")
    resp = eng.generate_tokens(prompt, max_new_tokens=128, stop_ids=set(), session_id="main")
    resumed = eng.generate_tokens(more, max_new_tokens=32, stop_ids=set(), session_id="main")
    torch.cuda.synchronize()
    launches = {"q4_matmul": q4_matmul.launches, "flash_prefill": flash_prefill.launches}

    n_prefill, n_decode = N_TTFT + 2, N_TTFT + 128 + 32
    per_layer_k1 = 4
    expect = {"q4_matmul": n_prefill * per_layer_k1 * cfg.n_layers
              + n_decode * (per_layer_k1 * cfg.n_layers + 1),
              "flash_prefill": n_prefill * cfg.n_layers}
    print(f"main path launches {launches}, expected {expect} "
          f"({per_layer_k1 * cfg.n_layers + 1} K1 per decode step, "
          f"{cfg.n_layers} K3 per prefill)", flush=True)
    if launches != expect or min(launches.values()) == 0:
        fail(f"launch counts {launches} != expected {expect}")
    for r, n in [(f, 1) for f in firsts] + [(resp, 128), (resumed, 32)]:
        if len(r.token_ids) != n or not all(0 <= t < cfg.vocab_size for t in r.token_ids):
            fail(f"bad token ids: {r.token_ids[:8]}... ({len(r.token_ids)} of {n})")
    if len({f.token_ids[0] for f in firsts}) != 1 or firsts[0].token_ids[0] != resp.token_ids[0]:
        fail("greedy first tokens of the same prompt differ between runs")
    if eng.sessions["main"].position != 512 + 128 + 64 + 32 - 1:
        fail(f"session position {eng.sessions['main'].position}")
    ttft_ms = statistics.median(ttfts)
    decode_tps = 128 / (resp.generate_time_ms / 1000)
    print(f"TTFT (512-token prompt, first token) median {ttft_ms:.2f} ms of {N_TTFT} runs "
          f"(min {min(ttfts):.2f}, max {max(ttfts):.2f}); decode {decode_tps:.1f} tok/s "
          f"(128 tokens, batch 1) on {card_note}", flush=True)

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
    e2e = dict(ttft_ms=ttft_ms, ttft_ms_runs=ttfts, decode_tok_s=decode_tps, logits_rel_l2=rel,
               decode_ms_per_token=resp.generate_time_ms / 128,
               prefill_ms_512=resp.prompt_time_ms)
    return launches, e2e, (eng, prompt)


def profile_path(torch, eng, prompt) -> dict:
    """Device time by kernel and the device's busy share over two windows of
    the main path, with torch.profiler (whose own host cost lowers the busy
    share it reports, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, ids, n in (("prefill 511 + first token", prompt, 1),
                          ("decode 32 tokens", [], 32)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate_tokens(ids, max_new_tokens=n, stop_ids=set(), session_id="prof")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = []
        for e in prof.key_averages():
            if not str(e.device_type).endswith("CUDA"):
                continue
            kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
        kernels.sort(reverse=True)
        dev_ms = sum(k[0] for k in kernels)
        if dev_ms <= 0:
            fail(f"profile {label}: the profiler saw no device time")
        groups = {"q4_matmul": 0.0, "flash_prefill": 0.0, "other": 0.0}
        for ms, _, key in kernels:
            g = ("q4_matmul" if "q4_ge" in key else
                 "flash_prefill" if "flash_prefill" in key else "other")
            groups[g] += ms
        n_ops = sum(c for _, c, _ in kernels)
        out[label] = dict(wall_ms=wall_ms, device_ms=dev_ms, busy_share=dev_ms / wall_ms,
                          device_ops=n_ops, by_group_ms=groups,
                          top=[dict(ms=ms, count=c, kernel=key[:90]) for ms, c, key in kernels[:12]])
        print(f"profile {label}: wall {wall_ms:.2f} ms (profiler on), device {dev_ms:.2f} ms, "
              f"busy share {dev_ms / wall_ms:.3f}, {n_ops} device ops; by group "
              + ", ".join(f"{g} {v:.2f} ms" for g, v in groups.items()), flush=True)
        for ms, c, key in kernels[:12]:
            print(f"  {ms:8.3f} ms {c:6d}x {key[:90]}")
    return out


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

    # 3. kernels against their plain versions
    timer = Timer(torch)
    print(f"bound = max(bytes / {HBM_BYTES_PER_S / 1e12:.2f} TB/s, operations / "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16): the H100 SXM data-sheet peaks at 700 W "
          "(a PCIe card or a lower power limit has lower peaks)", flush=True)
    details: list[dict] = []
    k1 = check_k1(torch, timer, details)
    k3 = check_k3(torch, timer, details)
    del timer

    # 4. the main path
    launches, e2e, (eng, prompt) = main_path(torch, smi)
    # 5. where the main path's time goes
    prof = profile_path(torch, eng, prompt)
    del eng

    kernels = [
        dict(name="q4_matmul", route="cuda", source="jlama_tpu_torch/csrc/q4_matmul.cu",
             replaces="jlama_tpu/ops/pallas_q4.py:113", launches=launches["q4_matmul"], **k1),
        dict(name="flash_prefill", route="cuda", source="jlama_tpu_torch/csrc/flash_prefill.cu",
             replaces="jlama_tpu/ops/pallas_attention.py:41",
             launches=launches["flash_prefill"], **k3),
    ]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "kernels": kernels, "shapes": details, "main_path": e2e,
             "profile": prof}, indent=1))
    print(f"card {smi}: " + json.dumps(e2e), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
