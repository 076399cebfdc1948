"""Quantization quality on trained weights (counterpart of
`scripts/ppl_trained.py`).

Trains a small llama with Adam on a synthetic Markov corpus
(fixed seeds, nothing downloaded) through the train step's `loss_fn`
(`parallel/train.py`, bf16 activations on f32 parameters) until the loss
drops well below the corpus's start, then scores held-out perplexity with
the weights in f32, JQ4 (block-32 q4, through K1), q8 and q4s (through K5),
and requires JQ4 within 0.1 of f32 (the `BASELINE.md` budget). The corpora
are the JAX script's, array for array, from the same seeds; the model's
initial draw differs (the port's `models.init.init_params` draws its leaves
in another order), so its figures are comparable with
`PPL_TRAINED_r05.json`, not equal to them.

    python -m jlama_tpu_torch.scripts.ppl_trained [--steps N] [--small]
        [--out FILE] [--device cuda|cpu]

Prints the result's JSON (the JAX script's keys) and writes it to `--out`
when given. Exits non-zero when the loss does not drop by more than 1.0 or
JQ4's perplexity is more than 0.1 from f32's.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

BUDGET = 0.1
KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def markov_corpus(vocab: int, n_tokens: int, seed: int, branch: int = 4) -> np.ndarray:
    """A first-order Markov chain with `branch` successors per state (the JAX
    script's numpy code): the transition table from a fixed seed shared by
    every corpus, the path from `seed`."""
    rng_table = np.random.default_rng(12345)
    succ = rng_table.integers(0, vocab, (vocab, branch)).astype(np.int32)
    probs = rng_table.dirichlet(np.full(branch, 0.7), size=vocab)
    cum = np.cumsum(probs, axis=1)
    rng = np.random.default_rng(seed)
    out = np.empty(n_tokens, np.int32)
    a = 0
    u = rng.random(n_tokens)
    for i in range(n_tokens):
        k = min(int(np.searchsorted(cum[a], u[i])), branch - 1)
        a = int(succ[a, k])
        out[i] = a
    return out


def quantize_layers(params: dict, fmt: str) -> dict:
    """The layers' projections in `fmt` (q4, q8 or q4s), on their device;
    norms and embeddings stay float (the set the JAX script quantizes).
    q4s needs every K a multiple of 256 (`ops.w8a8.to_q4s` raises
    otherwise)."""
    from ..nn.qarray import QArray
    from ..ops.w8a8 import to_q4s
    from ..quant import blockq

    def q(w):
        if fmt == "q4":
            return QArray(*blockq.q4_quantize(w), "q4")
        if fmt == "q8":
            return QArray(*blockq.q8_quantize_checkpoint(w), "q8")
        if fmt == "q4s":
            return to_q4s(QArray(*blockq.q4_quantize(w), "q4"))
        raise ValueError(fmt)

    out = dict(params)
    out["layers"] = [{k: (q(v) if k in KEYS else v) for k, v in d.items()}
                     for d in params["layers"]]
    return out


def adam_train(params: dict, cfg, corpus: np.ndarray, steps: int, batch: int = 16,
               seq: int = 129, lr: float = 3e-3, log_every: int = 50):
    """Adam on the causal-LM loss (`parallel.train.loss_fn`), the JAX
    script's formula and batches; params are updated in place. Returns
    (params, [(step, loss)]). On the card, after 3 eager steps, the step
    (forward, backward and update) is one captured CUDA graph, replayed
    with each step's batch and bias corrections copied into its static
    inputs, as the JAX script jits its step."""
    from ..models.base import rope_inv_freq
    from ..parallel.train import tree_leaves, value_and_grad

    leaves = tree_leaves(params)
    device = leaves[0].device
    m = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    v = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    b1, b2, eps = 0.9, 0.999, 1e-8
    # every step's batch (the JAX script's draws, in its order) and bias
    # corrections, on the device at once; a step copies its own into
    # `tokens` and `bc`
    rng = np.random.default_rng(0)
    n = len(corpus) - seq
    starts = [rng.integers(0, n, batch) for _ in range(steps)]
    batches = torch.from_numpy(np.stack([np.stack([corpus[s:s + seq] for s in st])
                                         for st in starts]).astype(np.int64)).to(device)
    corrections = torch.tensor([[1 - b1 ** t, 1 - b2 ** t] for t in range(1, steps + 1)],
                               dtype=torch.float32, device=device)
    tokens = torch.empty_like(batches[0])
    bc = torch.empty_like(corrections[0])
    positions = torch.arange(seq, device=device).expand(batch, -1)
    inv_freq = rope_inv_freq(cfg, device)

    def step():
        loss, grads = value_and_grad(params, cfg, tokens, positions, inv_freq=inv_freq)
        with torch.no_grad():
            # the formula leaf by leaf, each op over all leaves in one call
            g = [torch.zeros_like(mi) if gi is None else gi.to(torch.float32)
                 for gi, mi in zip(tree_leaves(grads), m, strict=True)]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
            mh = torch._foreach_div(m, bc[0])
            vh = torch._foreach_div(v, bc[1])
            torch._foreach_sub_(leaves, torch._foreach_div(
                torch._foreach_mul(mh, lr), torch._foreach_add(torch._foreach_sqrt(vh), eps)))
        return loss

    cuda = device.type == "cuda"
    # the eager steps run on a side stream on the card, as a capture's
    # warm-up must
    side = torch.cuda.Stream(device) if cuda else None
    graph = None
    trace = []
    for t in range(1, steps + 1):
        tokens.copy_(batches[t - 1])
        bc.copy_(corrections[t - 1])
        if graph is not None:
            graph.replay()
        elif cuda and t > 3:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                loss = step()
            graph.replay()
        elif cuda:
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                loss = step()
            torch.cuda.current_stream(device).wait_stream(side)
        else:
            loss = step()
        if t % log_every == 0 or t == 1:
            trace.append((t, float(loss)))
            print(f"  step {t}: loss {float(loss):.4f}", flush=True)
    return params, trace


def config(small: bool):
    from ..config import from_hf_config

    return from_hf_config({
        "model_type": "llama", "hidden_size": 128 if small else 256,
        "intermediate_size": 384 if small else 768,
        "num_attention_heads": 4 if small else 8,
        "num_key_value_heads": 2 if small else 4,
        "num_hidden_layers": 2 if small else 6, "rms_norm_eps": 1e-5, "vocab_size": 256,
        "max_position_embeddings": 512, "rope_theta": 10000.0, "bos_token_id": 0,
        "eos_token_id": 0, "hidden_act": "silu",
    })


def run(steps: int = 400, small: bool = False, device=None) -> dict:
    """Train, score the four formats and return the JAX script's JSON keys,
    plus `launches` (K1's and K5's per format) and `train_s`."""
    from ..device import resolve_device
    from ..eval.ppl import score_tokens
    from ..models.init import init_params
    from ..ops.q4_matmul import q4_matmul
    from ..ops.w8a8 import q4s_matmul

    device = resolve_device(device)
    cfg = config(small)
    vocab = cfg.vocab_size
    print("generating corpus ...", flush=True)
    train_corpus = markov_corpus(vocab, 200_000, seed=1)
    held_out = markov_corpus(vocab, 4_000 if small else 20_000, seed=2)
    params = init_params(cfg, dtype=torch.float32, quantize=None, device=device)
    print(f"training {steps} steps ...", flush=True)
    t0 = time.perf_counter()
    params, trace = adam_train(params, cfg, train_corpus, steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    print(f"trained in {train_s:.0f}s", flush=True)
    loss0, loss_n = trace[0][1], trace[-1][1]
    results, launches = {}, {}
    for fmt in ("fp32", "q4", "q8", "q4s"):
        try:
            p = params if fmt == "fp32" else quantize_layers(params, fmt)
        except ValueError as e:  # q4s needs K % 256 == 0 (--small's widths do not)
            print(f"  ppl[{fmt}] skipped: {e}", flush=True)
            continue
        before = (q4_matmul.launches, q4s_matmul.launches)
        ppl = score_tokens(p, cfg, held_out, seq_len=512, stride=256, device=device)
        launches[fmt] = {"q4_matmul": q4_matmul.launches - before[0],
                         "w8a8_matmul": q4s_matmul.launches - before[1]}
        results[fmt] = round(float(ppl), 5)
        print(f"  ppl[{fmt}] = {ppl:.5f}", flush=True)
    delta_q4 = abs(results["q4"] - results["fp32"])
    delta_q8 = abs(results["q8"] - results["fp32"])
    return {
        "protocol": "trained-weights ppl delta (synthetic Markov corpus, deterministic seeds; "
                    "jlama_tpu_torch/scripts/ppl_trained.py)",
        "model": {"d": cfg.embedding_length, "layers": cfg.n_layers, "vocab": vocab,
                  "train_steps": steps},
        "loss_first": round(loss0, 4),
        "loss_final": round(loss_n, 4),
        "entropy_bound_nats": round(math.log(4), 4),
        "ppl": results,
        "delta_q4_vs_fp32": round(delta_q4, 5),
        "delta_q8_vs_fp32": round(delta_q8, 5),
        "budget": BUDGET,
        "pass_q4": delta_q4 <= BUDGET,
        "pass_q8": delta_q8 <= BUDGET,
        "device": str(device),
        "launches": launches,
        "train_s": train_s,
    }


def failures(out: dict) -> list[str]:
    """The script's two requirements, as sentences where they fail."""
    bad = []
    if not out["loss_final"] < out["loss_first"] - 1.0:
        bad.append(f"training did not converge: {out['loss_first']} -> {out['loss_final']}")
    if not out["pass_q4"]:
        bad.append(f"JQ4 ppl delta {out['delta_q4_vs_fp32']} exceeds the {BUDGET} budget")
    return bad


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", help="write the result's JSON here")
    ap.add_argument("--device", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.steps, args.small, args.device)
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=1))
    bad = failures(out)
    if bad:
        sys.exit("; ".join(bad))


if __name__ == "__main__":
    main()
