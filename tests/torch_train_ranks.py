"""The rank processes of tests/test_torch_train_mesh.py: four gloo ranks on
the CPU run the port's train step (`parallel/train.py`) on meshes of two or
four ranks, one world a mesh (each world joined through a FileStore of its
own and torn down after its cases; two worlds of two ranks run side by
side). Each case takes a tree the test process wrote (the JAX tree as
numpy, through `models.convert.from_jax_params`) and the same batch, and
records on every rank:

- the f32 composition (`make_value_and_grad(dtype=float32)`): the loss, the
  rank's gradient leaves, its leaves after `sgd_`, and their digests;
- one `make_train_step` step (bf16 activations) from the same tree: the
  loss, its leaves after the step and their digests.

Imports torch and the port only (the processes start with `spawn`). The
ranks start and are reaped through tests/torch_tp_ranks.py's helpers,
under their deadline."""

import pickle
from pathlib import Path

WORLD = 4
LR = 0.5
# each round: (mesh (dp, pp, tp), the cases' trees, the ranks of its world)
ROUNDS = (
    (((2, 1, 1), ("llama_tied",), (0, 1)), ((1, 1, 2), ("llama_tied", "llama"), (2, 3))),
    (((1, 2, 1), ("llama_tied",), (0, 1)), ((1, 1, 2), ("mixtral",), (2, 3))),
    (((2, 1, 2), ("llama_tied", "llama"), (0, 1, 2, 3)),),
    (((1, 2, 2), ("llama_tied", "llama"), (0, 1, 2, 3)),),
    (((2, 2, 1), ("llama_tied",), (0, 1, 2, 3)),),
)


def _case(mesh, params, cfg, tokens, positions):
    import torch

    from jlama_tpu_torch.parallel.mesh import rank_params
    from jlama_tpu_torch.parallel.pipeline import stage_range
    from jlama_tpu_torch.parallel.train import (_named_leaves, make_train_step,
                                                make_value_and_grad, sgd_, tree_leaves)
    from jlama_tpu_torch.scripts.train_check import digest, leaf_key

    first = stage_range(cfg.n_layers, mesh.pp, mesh.stage)[0]

    def fresh():
        tree, _, _ = rank_params(params, cfg, mesh, "cpu")
        tree.update({k: v.clone() for k, v in tree.items() if k != "layers"})
        tree["layers"] = [{k: v.clone() for k, v in d.items()} for d in tree["layers"]]
        return tree

    def leaves(tree):
        names = [n for n, _ in _named_leaves(tree)]
        return ({n: v.numpy().copy() for n, v in zip(names, tree_leaves(tree))},
                {leaf_key(n, mesh, first, tree.vocab): digest(v)
                 for n, v in zip(names, tree_leaves(tree))})

    tree = fresh()
    names = [n for n, _ in _named_leaves(tree)]
    loss, grads = make_value_and_grad(cfg, mesh, dtype=torch.float32)(tree, tokens, positions)
    out = {"f32_loss": float(loss),
           "f32_grads": {n: g.numpy().copy() for n, g in zip(names, tree_leaves(grads))
                         if g is not None}}
    sgd_(tree, grads, LR)
    out["f32_params"], out["f32_digests"] = leaves(tree)
    tree = fresh()
    _, loss = make_train_step(cfg, mesh, lr=LR)(tree, tokens, positions)
    out["bf16_loss"] = float(loss)
    out["bf16_params"], out["bf16_digests"] = leaves(tree)
    return out


def train_rank_main(rank, store_base, data_path, out_dir):
    """For each round, this rank's world: join it, run its cases, leave."""
    import torch

    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.convert import from_jax_params
    from jlama_tpu_torch.parallel.distributed import init_mesh_group, shutdown

    torch.set_num_threads(1)
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    tokens, positions = (torch.from_numpy(data[k]).long() for k in ("tokens", "positions"))
    results = {}
    for i, worlds in enumerate(ROUNDS):
        for j, (dims, cases, ranks) in enumerate(worlds):
            if rank not in ranks:
                continue
            dp, pp, tp = dims
            mesh = init_mesh_group(dp, tp, ranks.index(rank), pp=pp, device="cpu",
                                   store_path=f"{store_base}.{i}.{j}", timeout_s=60)
            res = results[dims, cases] = {"stage": mesh.stage, "dp_index": mesh.dp_index,
                                          "tp_rank": mesh.group.rank}
            for name in cases:
                tree, hf = data["trees"][name]
                res[name] = _case(mesh, from_jax_params(tree, device="cpu"),
                                  from_hf_config(hf), tokens, positions)
            shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
