"""Serving times of a bf16 Mixtral on one GPU, for two checkouts of the port
compared in one machine.

    python jlama_tpu_torch/scripts/serve_timing.py --root DIR [--layers 8]
        [--reps 5] [--out FILE]

Imports `jlama_tpu_torch` from `--root` (a checkout of the repo), so one
copy of this script times any checkout that has the same entry points
(`models.init.random_float_params`, `runtime.engine.Engine`,
`runtime.scheduler.BatchScheduler`). The model is chip_smoke.py's phase 14:
Mixtral-8x7B's widths, `--layers` of its 32 layers, every weight bf16 from
seed 0, the experts through the card's grouped product. Measured, after a
warm-up that captures every graph used:

- the Engine (decode graphs, prefill graphs): the first token of a
  512-token prompt (its prefill and first sample), median of `--reps`;
  64 greedy tokens after it, ms a token, median of `--reps`;
- a 16-slot BatchScheduler (phase 14's settings): a decode step with every
  slot decoding (graph replays), ms a step over 16 steps, median of
  `--reps`; the greedy ids of 8 requests, printed as a digest, so that two
  checkouts can be seen to serve the same tokens;
- torch.profiler over one Engine request (the 512-token prefill and 16
  decode steps): the device ms of the five heaviest kernels, the
  lm_head's among them.

Prints one line a figure and the JSON of all on its last line (also to
--out). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose jlama_tpu_torch to time")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, a.root)

    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    import jlama_tpu_torch
    from jlama_tpu_torch.models.init import mixtral_8x7b_config, random_float_params
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

    if not torch.cuda.is_available():
        print("serve_timing: no CUDA device", flush=True)
        return 1
    card = _card()
    out = {"root": a.root, "package": jlama_tpu_torch.__file__, "card": card,
           "torch": torch.__version__, "layers": a.layers}
    cfg = dataclasses.replace(mixtral_8x7b_config(), n_layers=a.layers)
    t0 = time.perf_counter()
    params = random_float_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (512,), generator=g).tolist()

    def sync_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, r

    # the Engine
    eng = Engine(params, cfg, device="cuda", max_seq_len=1024)
    for _ in range(3):  # the prefill key's first use, its capture, a replay
        eng.generate_tokens(prompt, max_new_tokens=8, stop_ids=set(), session_id="warm")
        eng.drop_session("warm")
    ttft, per_tok, ids = [], [], None
    for i in range(a.reps):
        ms, _ = sync_ms(lambda: eng.generate_tokens(prompt, max_new_tokens=1, stop_ids=set(),
                                                    session_id=f"t{i}"))
        eng.drop_session(f"t{i}")
        ttft.append(ms)
        r = eng.generate_tokens(prompt, max_new_tokens=64, stop_ids=set(), session_id=f"d{i}")
        torch.cuda.synchronize()
        eng.drop_session(f"d{i}")
        per_tok.append(r.generate_time_ms / 64)
        ids = ids or r.token_ids
    out["engine"] = dict(ttft_ms=statistics.median(ttft), ttft_ms_runs=ttft,
                         decode_ms_per_token=statistics.median(per_tok),
                         decode_ms_per_token_runs=per_tok,
                         ids_digest=hashlib.sha256(str(ids).encode()).hexdigest()[:16])
    print(f"engine: first token of a 512-token prompt {out['engine']['ttft_ms']:.3f} ms "
          f"(median of {a.reps}: {', '.join(f'{x:.3f}' for x in ttft)}); decode "
          f"{out['engine']['decode_ms_per_token']:.4f} ms a token (64 tokens, median of "
          f"{a.reps}: {', '.join(f'{x:.4f}' for x in per_tok)}); ids "
          f"{out['engine']['ids_digest']} on {card}", flush=True)
    # the Engine under the profiler: a prefill and 16 decode steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate_tokens(prompt, max_new_tokens=17, stop_ids=set(), session_id="p")
        torch.cuda.synchronize()
    eng.drop_session("p")
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages() if str(e.device_type).endswith("CUDA")),
                     reverse=True)
    out["engine_profile"] = dict(
        device_ms=sum(k[0] for k in kernels),
        top=[dict(ms=ms, count=c, kernel=key[:100]) for ms, c, key in kernels[:5]])
    print(f"engine profile, a 512-token prefill and 16 decode steps: device "
          f"{out['engine_profile']['device_ms']:.3f} ms; heaviest: "
          + "; ".join(f"{ms:.3f} ms {c}x {key[:70]}" for ms, c, key in kernels[:5]), flush=True)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    # the 16-slot scheduler
    sched = BatchScheduler(params, cfg, kv_dtype=torch.bfloat16, device="cuda", fuse=False,
                           n_slots=16, n_pages=256, page_size=64, prefill_chunk=256,
                           decode_lag=4, max_seq_len=1024)
    gs = torch.Generator().manual_seed(9)

    def sids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gs).tolist()

    greedy = [GenRequest(prompt_ids=sids(int(torch.randint(32, 513, (1,), generator=gs))),
                         max_new_tokens=32) for _ in range(8)]
    for r in greedy:
        sched.submit(r)
    while not all(r.state == RequestState.DONE for r in greedy):
        sched.step()
    steps = []
    for _ in range(a.reps + 1):
        reqs = [GenRequest(prompt_ids=sids(64), max_new_tokens=40) for _ in range(16)]
        for r in reqs:
            sched.submit(r)
        while not all(r.state == RequestState.RUNNING and r.out_ids for r in reqs):
            sched.step()
        torch.cuda.synchronize()
        t, n0 = time.perf_counter(), sched.n_decode_steps
        while sched.n_decode_steps - n0 < 16:
            sched.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3 / (sched.n_decode_steps - n0))
        while not all(r.state == RequestState.DONE for r in reqs):
            sched.step()
    steps = steps[1:]  # the first round captures the keys it meets
    out["scheduler"] = dict(
        decode_ms_per_step=statistics.median(steps), decode_ms_per_step_runs=steps,
        ids_digest=hashlib.sha256(str([r.out_ids for r in greedy]).encode()).hexdigest()[:16])
    print(f"scheduler: a 16-slot decode step {out['scheduler']['decode_ms_per_step']:.3f} ms "
          f"(median of {len(steps)}: {', '.join(f'{x:.3f}' for x in steps)}); greedy ids of 8 "
          f"requests {out['scheduler']['ids_digest']} on {card}", flush=True)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
