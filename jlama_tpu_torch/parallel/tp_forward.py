"""The tensor-parallel forward's collectives and its context (counterpart of
`jlama_tpu/parallel/tp_forward.py`).

The JAX package runs its tp forward inside `jax.shard_map` in one process
over many devices. The torch idiom is one process per GPU: every rank runs
the same layer code on its own shard (`parallel/mesh.py::shard_params`) and
the shard_map forward's collectives become `torch.distributed` calls on the
rank's `TPGroup`:

- `tp_reduce`: the sum of a row-parallel projection's partial outputs (wo
  and w2), one all-reduce, before the bias (`jax.lax.psum`);
- `sharded_vocab_gather`: the embedding of a vocabulary-sharded table, a
  masked local gather, then one all-reduce;
- `gather_vocab_logits`: the lm_head's local logit columns, one all-gather
  in rank order.

A context variable carries the active `TPCtx` into the layer code
(`nn.layers`, `models.base`); outside a `tp_context` it is None and every
hook does what the single-device path did, with no extra launch and no
extra tensor.
"""

from __future__ import annotations

import contextvars
import time
from dataclasses import replace
from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..nn.qarray import QArray


class TPGroup:
    """One rank's view of its tp group over `torch.distributed`: rank, size,
    the process group, and the three collectives the forward and the
    scheduler use (in-place sum, all-gather in rank order, broadcast).

    gloo on CUDA tensors (the one-GPU card run puts two ranks on one device,
    where NCCL refuses): PyTorch's gloo takes CUDA tensors for some
    collectives and not for others, by version. At the first use of each
    (collective, dtype) on a CUDA tensor under gloo, every rank tries it
    once on a two-element tensor and the ranks agree, by a CPU all-reduce,
    whether all of them took it; a collective that any rank refused runs
    through pinned host memory from then on (copy out, the collective on
    the CPU, copy back), for the gloo backend only. This is the fixed route
    of that collective, decided once, not a retry after a failure: only an
    error that names CUDA counts as a refusal, and any other failure of the
    probe, like every later failure of the collective, raises. NCCL and CPU
    tensors take every collective directly. `routes` holds each decision;
    tests/test_torch_cuda_tp.py sets it to "host" to hold the staged route
    against the direct one on the card.
    """

    def __init__(self, rank: int, size: int, group=None, backend: str | None = None,
                 device: torch.device | None = None, store=None):
        import torch.distributed as dist

        self.rank = rank
        self.size = size
        self.group = group
        self.backend = backend or dist.get_backend(group)
        self.device = device
        self.store = store  # the rendezvous store (the step channel's port goes through it)
        self.routes: dict[tuple[str, torch.dtype], str] = {}  # -> "direct" | "host"
        self.calls, self.seconds = 0, 0.0  # collectives run, and their host seconds

    def _staged(self, op: str, t: torch.Tensor) -> bool:
        if t.device.type != "cuda" or self.backend != "gloo":
            return False
        key = (op, t.dtype)
        if key not in self.routes:
            import torch.distributed as dist

            probe = torch.zeros(2, dtype=t.dtype, device=t.device)
            try:
                self._direct(op, probe)
                took = 1
            except (RuntimeError, NotImplementedError) as e:
                if "cuda" not in str(e).lower():  # not a refusal of the device: a fault
                    raise
                took = 0
            agreed = torch.tensor([took], dtype=torch.int32)
            dist.all_reduce(agreed, op=dist.ReduceOp.MIN, group=self.group)
            self.routes[key] = "direct" if int(agreed) else "host"
        return self.routes[key] == "host"

    def _direct(self, op: str, t: torch.Tensor, dim: int = -1, src: int = 0):
        import torch.distributed as dist

        if op == "all_reduce":
            dist.all_reduce(t, group=self.group)
            return t
        if op == "broadcast":
            dist.broadcast(t, src=self._global(src), group=self.group)
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def _global(self, rank: int) -> int:
        import torch.distributed as dist

        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def _collective(self, op: str, t: torch.Tensor, dim: int = -1, src: int = 0):
        """The collective `op` on the contiguous t as a boundary op of the
        step being run (`runtime/graphs.py::boundary`): in a captured step
        it runs between two segments, on buffers made once and kept with
        the key's graph (t, which the segment before wrote, the pinned host
        copies of the staged route, the gathered output). The route is
        decided at build time, which a key's eager first use reaches first.
        Returns t (all_reduce, broadcast: in place) or the gathered tensor."""
        import torch.distributed as dist

        from ..runtime.graphs import boundary

        def build():
            staged = self._staged(op, t)
            x = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged else t
            out = cat = parts = None
            if op == "all_gather":
                shape = list(t.shape)
                shape[dim] *= self.size
                out = torch.empty(shape, dtype=t.dtype, device=t.device)
                cat = torch.empty(shape, dtype=t.dtype, pin_memory=True) if staged else out
                parts = [torch.empty_like(x) for _ in range(self.size)]

            def run():
                t0 = time.perf_counter()
                if staged:
                    x.copy_(t)
                if op == "all_reduce":
                    dist.all_reduce(x, group=self.group)
                elif op == "broadcast":
                    dist.broadcast(x, src=self._global(src), group=self.group)
                else:
                    dist.all_gather(parts, x, group=self.group)
                    torch.cat(parts, dim=dim, out=cat)
                if staged:
                    if out is None:
                        t.copy_(x)
                    else:
                        out.copy_(cat)
                self.calls += 1
                self.seconds += time.perf_counter() - t0

            return run, (t if out is None else out)

        return boundary((op, tuple(t.shape), t.dtype), build)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place."""
        c = t.contiguous()
        self._collective("all_reduce", c)
        if c is not t:
            t.copy_(c)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' `t` concatenated along `dim`, in rank order."""
        return self._collective("all_gather", t.contiguous(), dim=dim)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`t` from rank `src` (group rank), in place."""
        c = t.contiguous()
        self._collective("broadcast", c, src=src)
        if c is not t:
            t.copy_(c)
        return t


class TPCtx(NamedTuple):
    """The active tp group, read by nn.layers and models.base."""

    group: object  # a TPGroup, or anything with its rank, size and collectives
    embed_vocab_sharded: bool = False
    lm_head_vocab_sharded: bool = False


_CTX: contextvars.ContextVar[TPCtx | None] = contextvars.ContextVar(
    "jlama_tp_ctx", default=None
)


def current() -> TPCtx | None:
    return _CTX.get()


class tp_context:
    """Context manager installing a TPCtx for the calls inside it."""

    def __init__(self, ctx: TPCtx | None):
        self.ctx = ctx

    def __enter__(self) -> TPCtx | None:
        self._tok = _CTX.set(self.ctx)
        return self.ctx

    def __exit__(self, *exc) -> None:
        _CTX.reset(self._tok)


# Under autograd (the train step, `parallel/train.py`) each collective is
# one of Megatron's conjugate pairs: a sum whose backward is the identity,
# an identity whose backward is a sum (where a column-parallel block takes
# its replicated input, so that the input's gradient sums the ranks'
# parts), and the logits' gather, whose backward keeps this rank's columns.
# Outside autograd the forward runs as before, the sum in place.


def _differentiable(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, y, group):
        return group.all_reduce_(y.contiguous().clone())

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.group.all_reduce_(g.contiguous().clone()), None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(fctx, y, group):
        fctx.group, fctx.n = group, y.shape[-1]
        return group.all_gather(y, dim=y.ndim - 1)

    @staticmethod
    def backward(fctx, g):
        return g.narrow(-1, fctx.group.rank * fctx.n, fctx.n), None


def _sum(y: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks: in place, or out of place with an
    identity backward where y takes part in autograd."""
    return _Sum.apply(y, group) if _differentiable(y) else group.all_reduce_(y)


def tp_reduce(y: torch.Tensor) -> torch.Tensor:
    """Sum a row-parallel projection's partial outputs over the tp ranks
    (one all-reduce, in place; out of place under autograd, its backward
    the identity). The identity outside a tp context."""
    ctx = _CTX.get()
    if ctx is not None:
        y = _sum(y, ctx.group)
    return y


def tp_input(x: torch.Tensor) -> torch.Tensor:
    """x as a column-parallel block takes it: the identity, whose backward
    under autograd sums x's gradient over the tp ranks (each rank's block
    gives only its part). x itself outside a tp context or autograd."""
    ctx = _CTX.get()
    if ctx is None or not _differentiable(x):
        return x
    return _Copy.apply(x, ctx.group)


def sharded_vocab_gather(emb, tokens: torch.Tensor, group) -> torch.Tensor:
    """Embedding rows from a vocabulary-sharded table: each rank gathers the
    tokens it owns (zeros elsewhere), then one all-reduce assembles them
    (under autograd its backward reaches this rank's rows only).
    Returns f32 [B, T, D]."""
    local_v = emb.shape[0]
    idx = tokens - group.rank * local_v
    valid = (idx >= 0) & (idx < local_v)
    rows = emb[idx.clamp(0, local_v - 1)]
    x = rows.dequantize(torch.float32) if isinstance(rows, QArray) else rows.to(torch.float32)
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return _sum(x.contiguous(), group)


def gather_vocab_logits(logits: torch.Tensor, group) -> torch.Tensor:
    """The vocabulary-sharded logit columns concatenated into [..., V]
    (under autograd the backward keeps this rank's columns)."""
    if _differentiable(logits):
        return _GatherCols.apply(logits, group)
    return group.all_gather(logits, dim=logits.ndim - 1)


# the architectures tp serves: the JAX package's shard table, and GPT-2 and
# BERT, which it serves on a mesh through GSPMD with the same rules (their
# LayerNorms, learned positions, token types, BERT's embedding norm, pooler
# and classifier replicated; GPT-2's undivided vocabulary replicated with
# its tied lm_head, so its forward takes no vocabulary collective)
TP_ARCHS = ("llama", "mistral", "qwen2", "granite", "gemma", "gemma2", "mixtral", "gpt2",
            "bert")


def check_tp(cfg: ModelConfig, mesh, quantized: bool = False, n_slots: int | None = None,
             n_pages: int | None = None) -> None:
    """Raise, naming the condition, where the JAX package's `can_shard_map`
    (`jlama_tpu/parallel/tp_forward.py:121-156`) is false and its scheduler
    would fall back to GSPMD (the port has no GSPMD: a mesh request never
    runs unsharded): dp must divide the slots and the pages, tp the heads
    (and the experts of a MoE model, which expert parallelism cuts over tp)
    and the FFN's hidden size (GPT-2's and BERT's too: their w1 and its bias
    are column-parallel); pp must divide the layers, as the JAX pipeline
    requires (`jlama_tpu/parallel/pipeline.py:99, 202, 263`), and a pp > 1
    mesh needs the rank's stage ring. At tp = 1 the weights are whole on
    every rank of a stage, and a dp mesh serves what one device serves."""
    tp, dp, pp = mesh.tp, mesh.dp, mesh.pp
    if pp > 1:
        if cfg.n_layers % pp:
            raise ValueError(f"n_layers must divide by pp (n_layers={cfg.n_layers}, pp={pp})")
        if mesh.ring is None:
            raise ValueError(f"mesh pp={pp} needs this rank's stage ring (mesh.ring, from "
                             "parallel.distributed.init_mesh_group)")
    if dp > 1:
        if n_slots is not None and n_slots % dp:
            raise ValueError(f"dp={dp} does not divide n_slots={n_slots} (each dp group "
                             "owns n_slots/dp slots)")
        if n_pages is not None and n_pages % dp:
            raise ValueError(f"dp={dp} does not divide n_pages={n_pages} (each dp group "
                             "owns n_pages/dp pages of the pool)")
    if tp == 1:
        return
    if cfg.model_type not in TP_ARCHS:
        raise NotImplementedError(f"tp for {cfg.model_type}: tp serves "
                                  f"{', '.join(TP_ARCHS)}")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} does not divide the heads (n_heads={cfg.n_heads}, "
                         f"n_kv_heads={cfg.n_kv_heads})")
    if cfg.n_experts and cfg.n_experts % tp:
        raise ValueError(f"tp={tp} does not divide n_experts={cfg.n_experts} (expert "
                         "parallelism gives each rank n_experts/tp experts)")
    if not cfg.n_experts and cfg.hidden_length % tp:
        raise ValueError(f"tp={tp} does not divide hidden_length={cfg.hidden_length}")
    if quantized:
        # wo's input (n_heads*hd/tp) and w2's (hidden/tp) split the packed
        # payload and the block-32 scales: each slice must hold whole blocks
        # (a MoE layer's experts split on the expert axis, not on hidden)
        if ((cfg.n_heads // tp) * cfg.head_size) % 32:
            raise ValueError(f"tp={tp}: wo's input slice {(cfg.n_heads // tp) * cfg.head_size}"
                             " is no multiple of the q4 block (32)")
        if not cfg.n_experts and (cfg.hidden_length // tp) % 32:
            raise ValueError(f"tp={tp}: w2's input slice {cfg.hidden_length // tp} is no "
                             "multiple of the q4 block (32)")


def localize_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """A rank's view of the config: the head counts shrink by tp, and its
    fused rows are a plain [q; k; v] concatenation (fused_tp 1)."""
    if tp == 1:
        return cfg
    return replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                   fused_tp=1)
