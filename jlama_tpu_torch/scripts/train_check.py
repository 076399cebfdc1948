"""The train step on a mesh, checked rank by rank against one device.

    rank_train(mesh, spec) -> dict       (in every rank of a joined world)
    check_train(ranks, spec) -> [str]    (the failures, as sentences)

`spec` names the model ("llama1b" or "mixtral", cut to `spec["layers"]`,
or `hf_config`), the batch (`batch` rows of `seq` tokens, seeded), the
learning rate `lr` and the seed. Every rank draws the same f32 tree on its
device (`models.init.random_float_params`, every leaf f32; a MoE config's
experts float) and runs, all ranks in step:

1. one device's f32 composition of the step on the whole tree
   (`parallel.train.value_and_grad(dtype=float32)`), and of it keeps only
   its own slice (`parallel.mesh.rank_params` of the gradient tree): the
   reference;
2. the mesh's step at the same composition on the rank's tree
   (`make_value_and_grad`, then `sgd_`): its loss against one device's
   (`F32_LIMIT` relative), each gradient leaf's rel L2 from the reference's
   slice, and each stepped leaf's distance from p0 − lr·(the reference),
   relative to the update, against `F32_LIMIT` (`MOE_CARD_LIMIT` for a MoE
   model on the card) plus what the f32 rounding of the leaf itself allows
   (2^-23 of its norm over the update's); a digest of each updated leaf;
3. the mesh's train step as `make_train_step` runs it (bf16 activations)
   from the same tree: its loss against one device's `loss_fn` (`BF16_LIMIT`
   relative) and the digests of its updated leaves;
4. for a MoE model on the card (or with `witness` in the spec), the witness: steps 1 and 2's gradients and
   loss again with the float experts through `_moe_float_plain`
   (`nn.layers.plain_float_experts`: no bf16 rounding at f32 activations),
   held to `F32_LIMIT`, so that the card route's larger distance is shown
   to be its own bf16 rounding and not the mesh's.

With `bf16_reading` in the spec, step 1 also records each leaf's rel L2
between one device's bf16 gradients (`loss_fn`'s) and its f32 ones: what
a mesh whose f32 composition ran in bf16 would read, which
`MOE_CARD_LIMIT` must fail (`main`, the readings over several seeds).

Only the scalars of this comparison and the digests (computed on the
device) leave a rank (in its result), so no gradient goes through the host
for it. `check_train` then
requires every rank's distances within the limits, the same loss on every
rank, and each replicated leaf's digest equal on every rank that holds it
(`leaf_key`: the same layer and slice). K3 must not launch in any step.
chip_smoke.py's phases 17, 18 and 20 run it in their rank programs
(`tp_check.py`, `pp_check.py`); tests/test_torch_train_mesh.py holds the
step against `jlama_tpu` on gloo ranks of the CPU.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np

F32_LIMIT = 1e-4  # rel L2 of the mesh's f32 composition from one device's
# a MoE model's f32 gradients on the card: its float experts' route rounds x
# and the down projection to bf16 (ROADMAP §3), so tp's reordered f32 sums
# upstream flip some of those roundings. `main` over seeds 0-3 at
# Mixtral-8x7B's widths, 1 layer, tp = 2 (H100): the route's largest leaf
# 1.81e-3 to 3.04e-3, the witness through the plain experts 2.7e-6 to
# 9.2e-6 (so the gap is the route's own rounding), the bf16 readings it
# must fail 2.08e-2 to 8.16e-1 at their largest: the limit sits between,
# near their geometric middle
MOE_CARD_LIMIT = 8e-3
BF16_LIMIT = 1e-2  # relative distance of the mesh's bf16 step loss from one device's


def _config(spec):
    from ..config import from_hf_config
    from ..models.init import llama_1b_config, mixtral_8x7b_config

    if spec.get("hf_config"):
        return from_hf_config(spec["hf_config"])
    base = {"llama1b": llama_1b_config, "mixtral": mixtral_8x7b_config}[spec["model"]]()
    return replace(base, n_layers=spec["layers"])


# digest(): two sums of a leaf's bits, each bit pattern times a weight from
# its position, modulo a prime (exact in int64 on any device)
_DIGEST = ((2_147_483_647, 1_103_515_245, 12_345), (2_147_483_629, 69_069, 1))


def digest(t) -> str:
    """A digest of a leaf's bits, computed on its device in chunks: equal
    leaves give equal digests, and a leaf that differs in any bit a
    different one (but for a chance of about 2^-62)."""
    import torch

    raw = t.detach().contiguous().reshape(-1)
    raw = raw.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[raw.element_size()])
    sums = [0, 0]
    for start in range(0, raw.numel(), 1 << 24):
        bits = raw[start:start + (1 << 24)].to(torch.int64) & 0xFFFFFFFF
        pos = torch.arange(start, start + bits.numel(), device=raw.device, dtype=torch.int64)
        for j, (prime, a, c) in enumerate(_DIGEST):
            w = (pos * a + c) % prime
            sums[j] = (sums[j] + int(((bits % prime) * w % prime).sum())) % prime
    return f"{sums[0]:08x}{sums[1]:08x}"


def leaf_key(name: str, mesh, first_layer: int, vocab: tuple) -> tuple:
    """What a rank's leaf holds: its layer (global) or the top level, its
    name and its tp slice ("all" where the leaf is replicated over tp), so
    that ranks holding the same key must hold the same bits."""
    from ..parallel.mesh import COLUMN_PARALLEL, EXPERT_STACKS, ROW_PARALLEL, SPLIT_BIASES

    tp_rank = mesh.group.rank if mesh.tp > 1 else 0
    if name.startswith("layers["):
        i, k = name[len("layers["):].split("].", 1)
        cut = mesh.tp > 1 and k in COLUMN_PARALLEL + ROW_PARALLEL + SPLIT_BIASES + EXPERT_STACKS
        return ("layer", first_layer + int(i), k, tp_rank if cut else "all")
    cut = (name == "embed" and vocab[0]) or (name == "lm_head" and vocab[1])
    return ("top", name, tp_rank if cut else "all")


def _norm(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t.double()))


def rel_l2(a, b) -> float:
    """‖a − b‖ / ‖b‖ in f64 (‖a − b‖ where b is 0)."""
    import torch

    d = torch.linalg.vector_norm((a - b).double())
    n = torch.linalg.vector_norm(b.double())
    return float(d / n) if n > 0 else float(d)


def _filled(grads: dict, tree: dict) -> dict:
    """The gradient tree with zeros where a leaf had no gradient."""
    import torch

    return {**{k: (v if v is not None else torch.zeros_like(tree[k]))
               for k, v in grads.items() if k != "layers"},
            "layers": [{k: (v if v is not None else torch.zeros_like(tree["layers"][i][k]))
                        for k, v in d.items()} for i, d in enumerate(grads["layers"])]}


def _witness(cfg, mesh, tokens, positions, whole_tree) -> dict:
    """Step 4 of the module docstring: one device's and the mesh's f32
    gradients and loss with the float experts through `_moe_float_plain`;
    the loss pair and each leaf's rel L2."""
    import torch

    from ..nn.layers import plain_float_experts
    from ..parallel.mesh import rank_params
    from ..parallel.train import _named_leaves, make_value_and_grad, tree_leaves, value_and_grad

    f32, device = torch.float32, mesh.group.device
    with plain_float_experts():
        whole = whole_tree()
        ref_loss, ref = value_and_grad(whole, cfg, tokens, positions, dtype=f32)
        want, _, _ = rank_params(_filled(ref, whole), cfg, mesh, device)
        del ref
        tree, _, _ = rank_params(whole, cfg, mesh, device)
        del whole
        loss, grads = make_value_and_grad(cfg, mesh, dtype=f32)(tree, tokens, positions)
    g_rel = {n: rel_l2(torch.zeros_like(w) if g is None else g, w) for (n, _), g, w in zip(
        _named_leaves(tree), tree_leaves(grads), tree_leaves(want), strict=True)}
    return {"loss": float(loss), "one_device_loss": float(ref_loss), "grad_rel_l2": g_rel}


def rank_train(mesh, spec: dict) -> dict:
    """Steps 1-3 of the module docstring on this rank; its result."""
    import torch

    from ..models.init import random_float_params
    from ..ops.attention import flash_prefill
    from ..parallel.mesh import rank_params
    from ..parallel.pipeline import stage_range
    from ..parallel.train import (_named_leaves, loss_fn, make_train_step,
                                  make_value_and_grad, sgd_, tree_leaves, value_and_grad)

    cfg = _config(spec)
    device = mesh.group.device
    f32, lr = torch.float32, spec["lr"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def whole_tree():
        tree = random_float_params(cfg, spec["seed"], device, f32)
        for d in [tree] + tree["layers"]:
            for k, v in d.items():
                if isinstance(v, torch.Tensor):
                    d[k] = v.float()
        return tree

    rng = np.random.default_rng(spec["seed"])
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (spec["batch"], spec["seq"]))
                              ).to(device)
    positions = torch.arange(spec["seq"], device=device).expand(spec["batch"], -1)
    k3 = flash_prefill.launches
    card_moe = bool(cfg.n_experts) and device.type == "cuda"
    out = {"stage": mesh.stage, "dp_index": mesh.dp_index,
           "tp_rank": mesh.group.rank if mesh.tp > 1 else 0,
           "limit": MOE_CARD_LIMIT if card_moe else F32_LIMIT}
    # 1. one device, the whole tree: the reference, cut to this rank's slice
    t_start = time.perf_counter()
    whole = whole_tree()
    t0 = time.perf_counter()
    ref_loss, ref = value_and_grad(whole, cfg, tokens, positions, dtype=f32)
    with torch.no_grad():
        ref_bf16 = float(loss_fn(whole, cfg, tokens, positions))
    sync()
    out["one_device_ms"] = (time.perf_counter() - t0) * 1e3
    ref = _filled(ref, whole)
    if spec.get("bf16_reading"):
        _, ref_b = value_and_grad(whole, cfg, tokens, positions)
        out["bf16_reading"] = {n: rel_l2(b, w) for (n, _), b, w in zip(
            _named_leaves(whole), tree_leaves(_filled(ref_b, whole)), tree_leaves(ref),
            strict=True)}
        del ref_b
    want, _, _ = rank_params(ref, cfg, mesh, device)
    del ref
    # the rank's tree, twice (the f32 and the bf16 step); the whole tree freed
    tree, _, _ = rank_params(whole, cfg, mesh, device)
    tree.update({k: v.clone() for k, v in tree.items() if k != "layers"})
    tree["layers"] = [{k: v.clone() for k, v in d.items()} for d in tree["layers"]]
    del whole
    tree_b = type(tree)({k: (v.clone() if k != "layers" else
                             [{n: x.clone() for n, x in d.items()} for d in v])
                         for k, v in tree.items()}, tree.tp, tree.rank, tree.vocab, tree.pp,
                        tree.stage)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    first = stage_range(cfg.n_layers, mesh.pp, mesh.stage)[0]
    names = [n for n, _ in _named_leaves(tree)]
    before = [v.clone() for v in tree_leaves(tree)]
    # 2. the mesh's f32 composition, then its update
    vg = make_value_and_grad(cfg, mesh, dtype=f32)
    sync()
    t0 = time.perf_counter()
    loss, grads = vg(tree, tokens, positions)
    sgd_(tree, grads, lr)
    sync()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["loss"], out["one_device_loss"] = float(loss), float(ref_loss)
    g_rel, u_rel = {}, {}
    for n, g, w, p0, p in zip(names, tree_leaves(grads), tree_leaves(want), before,
                              tree_leaves(tree), strict=True):
        g_rel[n] = rel_l2(torch.zeros_like(w) if g is None else g, w)
        # the step against p0 − lr·w, with what the leaf's own f32 rounding
        # allows (2^-23 of its norm: a norm weight near 1 rounds its update)
        size = max(_norm(lr * w), 1e-30)
        u_rel[n] = (_norm(p - (p0 - lr * w)) / size, 2.0 ** -23 * _norm(p0) / size)
    out["grad_rel_l2"], out["update_rel_l2"] = g_rel, u_rel
    out["digests"] = {leaf_key(n, mesh, first, tree.vocab): digest(p)
                      for n, p in zip(names, tree_leaves(tree))}
    del grads, want, before, tree
    # 3. make_train_step (bf16 activations) from the same tree
    step = make_train_step(cfg, mesh, lr=lr)
    sync()
    t0 = time.perf_counter()
    _, loss_b = step(tree_b, tokens, positions)
    sync()
    out["bf16_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["bf16_loss"], out["one_device_bf16_loss"] = float(loss_b), ref_bf16
    out["bf16_digests"] = {leaf_key(n, mesh, first, tree_b.vocab): digest(p)
                           for n, p in zip(names, tree_leaves(tree_b))}
    del tree_b
    if device.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        torch.cuda.empty_cache()
    # 4. the witness: the f32 composition with the plain float experts
    if card_moe or (cfg.n_experts and spec.get("witness")):
        out["witness"] = _witness(cfg, mesh, tokens, positions, whole_tree)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["k3_launches"] = flash_prefill.launches - k3
    out["train_s"] = time.perf_counter() - t_start
    return out


def check_train(ranks: list[dict], spec: dict) -> list[str]:
    """What must hold of the ranks' `rank_train` results; the failures."""
    bad = []
    for r, res in enumerate(ranks):
        g = max(res["grad_rel_l2"].items(), key=lambda kv: kv[1])
        u = max(res["update_rel_l2"].items(), key=lambda kv: kv[1][0] - kv[1][1])
        lim = res["limit"]
        if not (g[1] <= lim and u[1][0] <= lim + u[1][1]):
            bad.append(f"train rank {r}: f32 composition against one device: gradient {g[0]} "
                       f"rel L2 {g[1]:.3e}, update {u[0]} {u[1][0]:.3e} (limit {lim} + "
                       f"the leaf's rounding {u[1][1]:.3e})")
        for what, w in (("", res), ("the witness's ", res.get("witness"))):
            if w is not None and not abs(w["loss"] - w["one_device_loss"]) <= F32_LIMIT * abs(
                    w["one_device_loss"]):
                bad.append(f"train rank {r}: {what}f32 loss {w['loss']} against one device's "
                           f"{w['one_device_loss']} (limit {F32_LIMIT})")
        if "witness" in res:
            wg = max(res["witness"]["grad_rel_l2"].items(), key=lambda kv: kv[1])
            if not wg[1] <= F32_LIMIT:
                bad.append(f"train rank {r}: the witness (plain float experts): gradient "
                           f"{wg[0]} rel L2 {wg[1]:.3e} from one device's (limit {F32_LIMIT})")
        if not abs(res["bf16_loss"] - res["one_device_bf16_loss"]) <= BF16_LIMIT * abs(
                res["one_device_bf16_loss"]):
            bad.append(f"train rank {r}: bf16 step loss {res['bf16_loss']} against one "
                       f"device's {res['one_device_bf16_loss']}")
        if res["k3_launches"]:
            bad.append(f"train rank {r}: {res['k3_launches']} K3 launches in the steps")
        if res["loss"] != ranks[0]["loss"] or res["bf16_loss"] != ranks[0]["bf16_loss"]:
            bad.append(f"train rank {r}: loss {res['loss']} / {res['bf16_loss']}, rank 0 "
                       f"{ranks[0]['loss']} / {ranks[0]['bf16_loss']}")
    for field in ("digests", "bf16_digests"):
        held: dict = {}
        for r, res in enumerate(ranks):
            for key, d in res[field].items():
                held.setdefault(key, []).append((r, d))
        shared = {k: v for k, v in held.items() if len(v) > 1}
        if len(ranks) > 1 and not shared:
            bad.append(f"train {field}: no leaf held by two ranks")
        for key, v in shared.items():
            if len({d for _, d in v}) > 1:
                bad.append(f"train {field}: {key} differs across ranks "
                           f"{[r for r, _ in v]}")
    return bad


def seeds_main(rank: int, world: int, store_path: str, out_path: str, spec: dict) -> None:
    """`rank_train` for each of spec["seeds"] on a tp = world mesh of one
    host (`main`'s rank program); pickles the list of results."""
    import pickle

    from ..parallel.distributed import init_mesh_group, shutdown

    mesh = init_mesh_group(1, world, rank, device=spec["device"], backend=spec["backend"],
                           store_path=store_path, timeout_s=spec["timeout_s"])
    res = [rank_train(mesh, dict(spec, seed=s)) for s in spec["seeds"]]
    shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


def _top(d: dict) -> tuple:
    return max(d.items(), key=lambda kv: kv[1])


def main(argv=None) -> int:
    """The train check's readings over several seeds: tp ranks of one host
    (gloo, all on --device), each seed's `rank_train` with `bf16_reading`,
    then `check_train`. Prints, a seed a line, the f32 composition's
    largest gradient distance (on the card for a MoE model the route that
    rounds to bf16), the witness's (plain experts), the losses, and the
    largest bf16 reading; writes every reading to --out as JSON.

        python -m jlama_tpu_torch.scripts.train_check --model mixtral --layers 1 --tp 2 \\
            --seeds 0 1 2 3 [--batch 2 --seq 64 --lr 0.1 --device cuda:0 --out FILE]

    (`--hf-config FILE --device cpu` runs a small model on the CPU.)
    """
    import argparse
    import json
    import pickle
    import tempfile

    from .tp_check import start_ranks, wait_ranks

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="mixtral", choices=("mixtral", "llama1b"))
    ap.add_argument("--hf-config", default=None,
                    help="a JSON file of an HF config, in place of --model and --layers")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    spec = dict(model=a.model, layers=a.layers, batch=a.batch, seq=a.seq, lr=a.lr,
                seeds=a.seeds, device=a.device, backend="gloo", timeout_s=a.timeout,
                bf16_reading=True)
    if a.hf_config:
        with open(a.hf_config) as f:
            spec["hf_config"] = json.load(f)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs, end = start_ranks(seeds_main, lambda r: (r, a.tp, f"{d}/store",
                                                        f"{d}/rank{r}.pkl", spec),
                                 a.tp, a.timeout)
        err = wait_ranks(procs, end)
        if err:
            print(f"train_check: {err}", flush=True)
            return 1
        ranks = []
        for r in range(a.tp):
            with open(f"{d}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    rows, bad = [], []
    for i, seed in enumerate(a.seeds):
        res = [rk[i] for rk in ranks]
        bad += [f"seed {seed}: {b}" for b in check_train(res, dict(spec, seed=seed))]
        for r, x in enumerate(res):
            row = dict(seed=seed, rank=r, limit=x["limit"], grad=_top(x["grad_rel_l2"]),
                       loss=x["loss"], one_device_loss=x["one_device_loss"],
                       bf16_reading=_top(x["bf16_reading"]),
                       bf16_reading_min=min(x["bf16_reading"].items(), key=lambda kv: kv[1]),
                       train_s=x["train_s"])
            if "witness" in x:
                w = x["witness"]
                row.update(witness=_top(w["grad_rel_l2"]), witness_loss=w["loss"],
                           witness_one_device_loss=w["one_device_loss"])
            rows.append(row)
            print(f"seed {seed} rank {r}: f32 gradient {row['grad'][0]} {row['grad'][1]:.4e} "
                  f"(limit {x['limit']}); loss {x['loss']:.6f} (one device "
                  f"{x['one_device_loss']:.6f})"
                  + (f"; the witness {row['witness'][0]} {row['witness'][1]:.4e}, loss "
                     f"{w['loss']:.6f} ({w['one_device_loss']:.6f})" if "witness" in x else "")
                  + f"; bf16 reading largest {row['bf16_reading'][0]} "
                  f"{row['bf16_reading'][1]:.4e}, smallest {row['bf16_reading_min'][0]} "
                  f"{row['bf16_reading_min'][1]:.4e}; {x['train_s']:.1f} s", flush=True)
    out = dict(spec=spec, rows=rows, failures=bad, wall_s=time.perf_counter() - t0,
               readings=[[{k: x[k] for k in ("grad_rel_l2", "bf16_reading")}
                          | ({"witness": x["witness"]["grad_rel_l2"]} if "witness" in x else {})
                          for x in rk] for rk in ranks])
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print("train_check: " + ("; ".join(bad) if bad else "every check passed")
          + f" ({out['wall_s']:.1f} s)", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
