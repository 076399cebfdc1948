"""The train step (counterpart of `jlama_tpu/parallel/train.py`).

- `loss_fn`: the causal-LM loss of `:20`: `forward_hidden` without a cache
  at the activation dtype (bf16 by default, as there, also on f32
  parameters), `lm_logits`, then the mean next-token NLL of a log-softmax
  over the f32 logits (`causal_lm_loss`, which also takes f32 or f64
  hidden states of a reference composition).
- `make_train_step(cfg, mesh, lr)`: one step, `train_step(params, tokens,
  positions) -> (params, loss)`: the gradients by autograd (`value_and_grad`),
  then SGD in place, p − lr·g in p's dtype (`sgd_`; the JAX step donates
  its parameters); a leaf without a gradient keeps its value. Float leaves
  only: a QArray leaf raises, as `jax.grad` takes no integer leaf.

The attention on this path is the dense masked branch at every head size
(`forward_hidden(..., dense_attention=True)`): K3 has no backward, as the
TPU kernel has none (JAX cannot differentiate through its `pallas_call`, so
its train step works only where its flash gate is false). Float MoE experts
differentiate through `nn.layers._moe_float_plain` on the CPU and through
`ops/moe_float.py` on the card (K6's gather with a scatter-add backward, the
grouped product's own backward); q4 experts are not trained, as in JAX.

On a mesh each rank runs the step on its own tree (`parallel/mesh.py::
rank_params`, a `RankSlice`), one process per rank over `torch.distributed`,
where the JAX step is one GSPMD program:

- dp: the batch rows split over the dp groups (B % dp == 0, `P("dp",
  None)`); the gradients, and the loss, averaged by one all-reduce over the
  dp group of the rank's (stage, tp rank) (`dp_group`);
- tp: the forward's collectives under autograd are Megatron's conjugate
  pairs (`parallel/tp_forward.py`): the sums after wo, w2 and the experts'
  combine pass the gradient on unchanged; the replicated input of each
  column-parallel block (wqkv, w13, the experts and their routing weights,
  a vocabulary-sharded lm_head) sums its gradient over the ranks; the
  vocabulary-sharded embedding's backward reaches the rank's rows only, the
  logits' gather keeps the rank's columns. So a rank's sharded leaves get
  their slice of the gradient and its replicated leaves the whole one, the
  same bits on every rank. Activations stay whole on each tp rank, where
  the JAX step shards their tokens over tp (`P("dp", "tp", None)`, a GSPMD
  layout of the same function);
- pp: stage by stage (`StageRing`): stage 0 embeds, each stage runs its
  layers and hands the hidden state on, the last computes the loss and
  broadcasts it; the backward runs in reverse, each stage sending the
  gradient of its input hidden state to the previous one. Every stage
  holds the top-level leaves (`stage_cut`), so their gradients are summed
  over the stages (one all-reduce): a tied embedding, used on stage 0 and
  on the last, then takes one update on both.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..nn.qarray import QArray


def causal_lm_loss(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """The mean NLL of tokens[:, 1:] under the logits of hidden [B, T, D]
    (`lm_logits`, f32; f64 from f64 hidden states)."""
    from ..models.base import lm_logits

    logits = lm_logits(params, cfg, hidden)[:, :-1]
    logp = torch.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0].mean()


def loss_fn(params: dict, cfg: ModelConfig, tokens: torch.Tensor, positions: torch.Tensor,
            dtype=torch.bfloat16, inv_freq: torch.Tensor | None = None) -> torch.Tensor:
    """The causal-LM loss of `jlama_tpu/parallel/train.py:loss_fn`, the
    activations in `dtype` (JAX's default bf16). inv_freq: as
    `forward_hidden` takes it (a step captured in a CUDA graph passes it, so
    that it copies nothing from the host)."""
    from ..models.base import forward_hidden

    hidden, _ = forward_hidden(params, cfg, tokens, positions, None, dtype=dtype,
                               inv_freq=inv_freq, dense_attention=True)
    return causal_lm_loss(params, cfg, hidden, tokens)


def _named_leaves(params: dict) -> list[tuple[str, torch.Tensor]]:
    """(name, leaf) of every leaf, top level first, then layer by layer;
    raises on a leaf that is not a float tensor, naming it."""
    out = [(k, v) for k, v in params.items() if k != "layers"]
    out += [(f"layers[{i}].{k}", v) for i, d in enumerate(params["layers"]) for k, v in d.items()]
    for name, v in out:
        if isinstance(v, QArray):
            raise TypeError(f"{name} is a {v.fmt} QArray: the train step takes float leaves "
                            "only (jax.grad takes no integer leaf either)")
        if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
            raise TypeError(f"{name} is no float tensor: the train step takes float leaves only")
    return out


def _tree(params: dict, leaves: list) -> dict:
    """The tree of `params`' structure over `leaves` (in `_named_leaves`'
    order)."""
    it = iter(leaves)
    top = {k: next(it) for k in params if k != "layers"}
    top["layers"] = [{k: next(it) for k in d} for d in params["layers"]]
    return top


def tree_leaves(tree: dict) -> list:
    """A tree's leaves in `_named_leaves`' order (None where a leaf has no
    gradient)."""
    return [v for k, v in tree.items() if k != "layers"] + [
        v for d in tree["layers"] for v in d.values()]


def sgd_(params: dict, grads: dict, lr: float) -> dict:
    """p ← p − lr·g in p's dtype, in place, for every leaf with a gradient
    (`make_train_step`'s update); returns params."""
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), tree_leaves(grads), strict=True):
            if g is not None:
                p.sub_(lr * g.to(p.dtype))
    return params


def value_and_grad(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, dtype=torch.bfloat16,
                   inv_freq: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """(loss, gradients) of `loss_fn` on one device: the gradients as a
    tree of params' structure, None for a leaf the loss does not use."""
    names = _named_leaves(params)
    alias = [v.detach().requires_grad_() for _, v in names]
    with torch.enable_grad():
        loss = loss_fn(_tree(params, alias), cfg, tokens, positions, dtype, inv_freq)
        grads = torch.autograd.grad(loss, alias, allow_unused=True)
    return loss.detach(), _tree(params, list(grads))


def dp_group(mesh):
    """The `TPGroup` of the ranks that hold this rank's (stage, tp rank) in
    every dp group: the train step's gradient average (None at dp = 1).
    Every rank of the world calls it: each `new_group` is collective, and
    the groups are made in one order."""
    import torch.distributed as dist

    from .tp_forward import TPGroup

    dp, pp, tp = mesh.dp, mesh.pp, mesh.tp
    if dp == 1:
        return None
    tp_rank = mesh.group.rank if tp > 1 else 0
    mine = None
    for s in range(pp):
        for t in range(tp):
            pg = dist.new_group([d * pp * tp + s * tp + t for d in range(dp)],
                                backend=mesh.group.backend)
            if (s, t) == (mesh.stage, tp_rank):
                mine = pg
    return TPGroup(mesh.dp_index, dp, mine, mesh.group.backend, mesh.group.device,
                   mesh.group.store)


def _sum_flat(tensors: list, group) -> None:
    """Sum the tensors over `group`'s ranks in place: one all-reduce of
    their concatenation (one a dtype)."""
    for dt in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dt]
        flat = torch.cat([t.reshape(-1) for t in same])
        group.all_reduce_(flat)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


def _stage_step(params, cfg, tokens, positions, dtype, ring, first_layer):
    """One stage's part of a pp step: its forward, the loss on the last
    stage, its backward from the gradient the next stage sent; returns
    (loss on the last stage else None, this stage's gradients)."""
    from ..models.base import _embed, forward_layers

    names = _named_leaves(params)
    alias = [v.detach().requires_grad_() for _, v in names]
    tree = _tree(params, alias)
    shape = (*tokens.shape, cfg.embedding_length)
    with torch.enable_grad():
        if ring.first:
            x_in, x = None, _embed(tree, cfg, tokens, positions, None, dtype)
        else:
            x_in = ring.recv_prev(shape, dtype).requires_grad_()
            x = x_in
        y = forward_layers(tree, cfg, x, positions, None, first_layer=first_layer,
                           dense_attention=True)
        wrt = alias + ([x_in] if x_in is not None else [])
        if ring.last:
            loss = causal_lm_loss(tree, cfg, y, tokens)
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        else:
            ring.send_next(y.detach())
            gy = ring.exchange_back(recv_next=(shape, dtype))
            loss = None
            grads = torch.autograd.grad(y, wrt, grad_outputs=gy, allow_unused=True)
    if x_in is not None:
        ring.exchange_back(send_prev=grads[-1])
    return loss, _tree(params, list(grads[:len(alias)]))


def make_value_and_grad(cfg: ModelConfig, mesh=None, dtype=torch.bfloat16):
    """`fn(params, tokens, positions) -> (loss, grads)` of the train step:
    on one device (`mesh` None or one rank) `value_and_grad`; on a mesh the
    rank's (module docstring): params its `RankSlice`, tokens and positions
    the whole batch [B, T] on its device; the loss the whole batch's mean
    on every rank, the gradients the rank's (its slices of the sharded
    leaves, all of the replicated ones), averaged over dp."""
    if mesh is None or mesh.dp * mesh.pp * mesh.tp == 1:
        return lambda params, tokens, positions: value_and_grad(params, cfg, tokens, positions,
                                                                dtype)
    from .pipeline import stage_range
    from .tp_forward import TPCtx, check_tp, localize_cfg, tp_context

    check_tp(cfg, mesh)
    dp, pp, tp = mesh.dp, mesh.pp, mesh.tp
    dpg = dp_group(mesh)
    lcfg = localize_cfg(cfg, tp)
    first_layer = stage_range(cfg.n_layers, pp, mesh.stage)[0]

    def fn(params, tokens, positions):
        vocab = getattr(params, "vocab", None)
        if tp > 1 and vocab is None:
            raise ValueError("a tp mesh's step takes the rank's RankSlice "
                             "(parallel.mesh.rank_params)")
        if tokens.shape[0] % dp:
            raise ValueError(f"dp={dp} does not divide the batch of {tokens.shape[0]} rows")
        b = tokens.shape[0] // dp
        tokens = tokens[mesh.dp_index * b:(mesh.dp_index + 1) * b]
        positions = positions[mesh.dp_index * b:(mesh.dp_index + 1) * b]
        with tp_context(TPCtx(mesh.group, *vocab) if tp > 1 else None):
            if pp == 1:
                loss, grads = value_and_grad(params, lcfg, tokens, positions, dtype)
            else:
                loss, grads = _stage_step(params, lcfg, tokens, positions, dtype, mesh.ring,
                                          first_layer)
        if pp > 1:
            # the loss from the last stage; the top-level leaves' gradients
            # summed over the stages (0 where a stage does not use a leaf)
            if loss is None:
                loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            loss = mesh.ring.broadcast_last(loss.detach().to(torch.float32).contiguous())
            top = [k for k in params if k != "layers"]
            for k in top:
                if grads[k] is None:
                    grads[k] = torch.zeros_like(params[k])
            _sum_flat([grads[k] for k in top], mesh.ring.group)
        if dpg is not None:
            parts = [g for g in tree_leaves(grads) if g is not None]
            parts.append(loss.detach().to(torch.float32).reshape(1))
            _sum_flat(parts, dpg)
            for g in parts:
                g.div_(dp)
            loss = parts[-1][0]
        return loss, grads

    return fn


def make_train_step(cfg: ModelConfig, mesh=None, lr: float = 1e-4):
    """`train_step(params, tokens, positions) -> (params, loss)`: the
    gradients of `make_value_and_grad` (bf16 activations, `loss_fn`'s),
    then `sgd_` in place (the JAX step's `p - lr * g.astype(p.dtype)`, its
    parameters donated). On a mesh every rank of the world calls this (a dp
    mesh makes its groups here) and each step."""
    vg = make_value_and_grad(cfg, mesh)

    def train_step(params, tokens, positions):
        loss, grads = vg(params, tokens, positions)
        return sgd_(params, grads, lr), loss

    return train_step
