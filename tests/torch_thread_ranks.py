"""Thread ranks: `ThreadGroup` stands in for a `TPGroup` where the tp ranks
are threads of one process, each collective a barrier, then a sum or a
concatenation in rank order. No JAX here, so that the card's tests use it
too."""

import threading

import torch


class _Shared:
    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=60)
        self.slots = [None] * size


class ThreadGroup:
    """A TPGroup stand-in for ranks that are threads of one process."""

    def __init__(self, shared: _Shared, rank: int):
        self.shared, self.rank, self.size = shared, rank, shared.size

    def _exchange(self, t):
        self.shared.slots[self.rank] = t.clone()
        self.shared.barrier.wait()
        parts = list(self.shared.slots)
        self.shared.barrier.wait()
        return parts

    def all_reduce_(self, t):
        parts = self._exchange(t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        t.copy_(total)
        return t

    def all_gather(self, t, dim=-1):
        return torch.cat(self._exchange(t), dim=dim)

    def broadcast_(self, t, src=0):
        t.copy_(self._exchange(t)[src])
        return t


def run_ranks(tp, fn):
    """fn(group) on tp threads; their results in rank order."""
    shared = _Shared(tp)
    out, errs = [None] * tp, []

    def run(rank):
        try:
            out[rank] = fn(ThreadGroup(shared, rank))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
            shared.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,), name=f"rank{r}", daemon=True)
               for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    return out


def tp_distance(params: dict, cfg, tokens: torch.Tensor, tp: int = 2, matmul=None) -> float:
    """Relative L2 of the port's tp = `tp` f32 logits (thread ranks, each its
    slice of the interleaved fused tree) from its one-device f32 logits, on
    the tree's device. `matmul(x, data, scales, out_dtype)`, where given,
    stands in for K1 (`ops/linear.py`'s q4_matmul) in both forwards."""
    from jlama_tpu_torch.models import base
    from jlama_tpu_torch.ops import linear
    from jlama_tpu_torch.parallel import mesh, tp_forward

    pos = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    saved = linear.q4_matmul
    if matmul is not None:
        linear.q4_matmul = lambda x, w, out_dtype=None: matmul(x, w.data, w.scales,
                                                               out_dtype or x.dtype)
    try:
        with torch.inference_mode():
            one = base.forward_logits(base.fuse_params(params), cfg, tokens, pos,
                                      dtype=torch.float32)[0]
        fused = base.fuse_params(params, tp=tp)
        embed_sh, lm_sh = mesh.vocab_flags(fused, tp)
        lcfg = tp_forward.localize_cfg(cfg, tp)

        def rank_fn(group):
            local = mesh.shard_params(fused, cfg, tp, group.rank)
            with torch.inference_mode(), \
                    tp_forward.tp_context(tp_forward.TPCtx(group, embed_sh, lm_sh)):
                return base.forward_logits(local, lcfg, tokens, pos, dtype=torch.float32)[0]

        got = run_ranks(tp, rank_fn)[0]
    finally:
        linear.q4_matmul = saved
    return float(torch.linalg.vector_norm(got - one) / torch.linalg.vector_norm(one))
