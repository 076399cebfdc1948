"""Single-stream TTFT and decode rate of Llama-3.2-1B (random JQ4 weights
from seed 0) through one tree's `Engine`, to compare two trees on one card
in turns (parent, change, change, parent).

    python jlama_tpu_torch/scripts/engine_ab.py [--tree DIR] [--reps 5]

DIR: the root of the checkout whose `jlama_tpu_torch` is imported (default:
the one holding this file); run the file by its path, so that no other
tree's package is imported first. Prints one JSON line: the TTFT of a
512-token prompt (its prefill and first token, host clock to a sync) and
the decode rate of 128 greedy tokens at batch 1 (the `Engine`'s chunks of
32), each per repetition and their median, beside the card's name and power
limit. Card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("engine_ab runs on a CUDA card only")
    import jlama_tpu_torch
    from jlama_tpu_torch.models.init import llama_1b_config, random_q4_params
    from jlama_tpu_torch.runtime.engine import Engine

    if Path(jlama_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {jlama_tpu_torch.__file__}, not the tree {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cfg = llama_1b_config()
    eng = Engine(random_q4_params(cfg, seed=0, device="cuda"), cfg, device="cuda",
                 max_seq_len=2048)
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (512,), generator=g).tolist()
    for _ in range(2):  # first uses, then the captures
        eng.generate_tokens(prompt, max_new_tokens=2, stop_ids=set(), session_id="warm")
        eng.drop_session("warm")
    ttft, rate = [], []
    for i in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate_tokens(prompt, max_new_tokens=1, stop_ids=set(), session_id="t")
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t0) * 1e3)
        eng.drop_session("t")
        r = eng.generate_tokens(prompt, max_new_tokens=128, stop_ids=set(), session_id="d")
        rate.append(128 / (r.generate_time_ms / 1e3))
        eng.drop_session("d")
    print(json.dumps(dict(tree=str(tree), card=card, ttft_ms=statistics.median(ttft),
                          ttft_ms_runs=ttft, decode_tok_s=statistics.median(rate),
                          decode_tok_s_runs=rate)), flush=True)


if __name__ == "__main__":
    main()
