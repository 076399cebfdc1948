"""Transformer layers as plain functions on tensors (counterpart of
`jlama_tpu/nn/layers.py`, its dense-cache and paged-cache paths).

Conventions, as in the JAX package:
- activations: [B, T, D]
- attention KV cache per layer: dense k, v [B, n_kv, S, head_size], or a
  `PagedLayerCache` (one layer's pools [n_kv, n_pages, ps, hd] and the
  batch's page tables [B, P])
- weights: [out, in] (HF Linear layout) — see ops.linear

Difference from the JAX package: caches are written in place, by the K4
kernel (`ops/kv_write.py`), since torch tensors are mutable and the write
then costs only the T new rows; the same launch applies RoPE to q and k
(the JAX package's two `apply_rope` calls before its write, which XLA fuses
with it), so a layer with a cache runs no separate RoPE. The dense cache is
a pool of B pages of S slots to K4, and to K2, which takes its T = 1
attention (the JAX package's dense decode runs the masked dense path
there). Only the path without a cache (perplexity windows) calls
`apply_rope` on its own.

Tensor parallelism (`parallel/tp_forward.py`): inside a tp context a rank
runs these functions on its slice of the weights with its share of the
heads; wo and w2 (`_row_parallel_linear`) sum their partial products over
the ranks before the bias. A fused weight interleaved per rank but run
whole on one device splits its output with `cfg.fused_tp` (`_split_fused`).
A MoE layer's experts are cut over the ranks instead (expert parallelism,
`moe_block`), its f32 combine summed the same way.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..kv.paged import gather_kv_layer, page_size_of, write_kv_layer
from ..ops.attention import HEAD_SIZES, flash_prefill, paged_decode
from ..ops.kv_write import dense_page_table, dense_pool_view, kv_write
from ..ops.linear import add_bias, linear
from ..ops.moe_float import moe_float_experts, stack_in_out
from ..ops.moe_q4 import moe_groups, moe_q4_gate_up, moe_q4_matmul
from ..parallel.tp_forward import current, tp_input, tp_reduce
from ..utils.debug import debug
from .qarray import QArray
from .rope import apply_rope


def _split_fused(y: torch.Tensor, sizes: tuple[int, ...], fused_tp: int) -> list:
    """Split a fused projection's output columns into its sections.

    fused_tp > 1: the fused rows were interleaved per tp rank
    (`models.base.fuse_params(params, tp)`), so the columns run [rank 0:
    a0, b0, ...; rank 1: a1, b1, ...]; each section's rank slices are
    regrouped into contiguous columns (views of y; a whole interleaved tree
    then runs on one device)."""
    if fused_tp == 1:
        return list(y.split(sizes, dim=-1))
    yr = y.reshape(*y.shape[:-1], fused_tp, y.shape[-1] // fused_tp)
    out, off = [], 0
    for s in sizes:
        sl = s // fused_tp
        out.append(yr[..., off:off + sl].reshape(*y.shape[:-1], s))
        off += sl
    return out


def _row_parallel_linear(x: torch.Tensor, w, bias=None) -> torch.Tensor:
    """A row-parallel (input-sharded) projection, wo or w2: in a tp context
    each rank's partial product comes out in f32, the partials are summed
    over the ranks (`tp_reduce`, one all-reduce) and cast to x's dtype
    once, BEFORE the bias, so that a bf16 sum rounds once, as one device's
    does (the JAX package's psum sums in the activation dtype); outside a tp
    context this is `linear(x, w, bias)`."""
    if current() is None:
        return linear(x, w, bias)
    y = tp_reduce(linear(x, w, out_dtype=torch.float32)).to(x.dtype)
    return y if bias is None else add_bias(y, bias)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             weight_offset: float = 0.0) -> torch.Tensor:
    ct = torch.promote_types(x.dtype, torch.float32)  # f32; f64 for an f64 reference
    xf = x.to(ct)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.to(ct)
    if weight_offset:
        w = w + weight_offset  # gemma's (1+w)
    return (normed * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.to(ct) + bias.to(ct)).to(x.dtype)


def norm(x, params: dict, cfg: ModelConfig, prefix: str) -> torch.Tensor:
    w = params[f"{prefix}.weight"]
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, w, cfg.norm_eps, cfg.rmsnorm_weight_offset)
    return layer_norm(x, w, params[f"{prefix}.bias"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


class _SiluSteps(torch.autograd.Function):
    """SiLU as the JAX package computes it, op by op in x's dtype: x · s,
    s = 1 / (1 + exp(−x)) (`jax.nn.silu` and `lax.logistic`'s lowering),
    each step rounded; the backward is JAX's too: g·s + (g·x)·(s·(1 − s)),
    each product and the sum rounded (`logistic`'s JVP rule)."""

    @staticmethod
    def forward(fctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        fctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(fctx, g):
        x, s = fctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


class _GeluTanhSteps(torch.autograd.Function):
    """GELU's tanh approximation as `jax.nn.gelu(approximate=True)` computes
    it, op by op in x's dtype: x · (0.5 · (1 + tanh(c · (x + a · x³)))),
    x³ = (x·x)·x, the constants a and c in x's dtype, each step rounded; the
    backward is JAX's linearization of those steps transposed: tanh's
    (g + g·t)·(1 − t), x³'s g·(3·x²), and x's three cotangents summed in the
    order JAX accumulates them."""

    @staticmethod
    def forward(fctx, x):
        a = torch.tensor(0.044715, dtype=x.dtype)
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
        t = torch.tanh(c * (x + a * ((x * x) * x)))
        cdf = 0.5 * (1 + t)
        fctx.save_for_backward(x, t, cdf)
        return x * cdf

    @staticmethod
    def backward(fctx, g):
        x, t, cdf = fctx.saved_tensors
        a = torch.tensor(0.044715, dtype=x.dtype)
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
        u = ((g * x) * 0.5) * (1 - t)  # through cdf = 0.5 (1 + t), into tanh's rule
        b = (u + u * t) * c  # the cotangent of x + a·x³
        return (g * cdf + b) + (b * a) * (3 * (x * x))


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP's activation. Under autograd (the train step) SiLU and GELU's
    tanh approximation round step by step as the JAX package's do, forward
    and backward (`_SiluSteps`, `_GeluTanhSteps`); elsewhere each is one
    fused op."""
    if kind in ("silu", "swish"):
        return _SiluSteps.apply(x) if _differentiable(x) else F.silu(x)
    if kind in ("gelu_new", "gelu_fast", "gelu_pytorch_tanh"):
        return _GeluTanhSteps.apply(x) if _differentiable(x) else F.gelu(x, approximate="tanh")
    if kind == "gelu":
        return F.gelu(x, approximate="none")
    if kind == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {kind!r}")


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class KVLayerCache(NamedTuple):
    k: torch.Tensor  # [B, n_kv, S, hd]
    v: torch.Tensor  # [B, n_kv, S, hd]


class PagedLayerCache(NamedTuple):
    """One layer's slice of the paged pool + the batch's page tables."""

    k_pool: object  # [n_kv, n_pages, ps, hd]: a tensor or a q8 QArray
    v_pool: object
    page_tables: torch.Tensor  # [B, P] int32


def attention_scores_mask(
    q_positions: torch.Tensor,  # [B, T] absolute positions of the query tokens
    kv_len: int,
    causal: bool,
    sliding_window: int | None,
    seq_lengths: torch.Tensor | None = None,  # [B] valid tokens per row
) -> torch.Tensor:
    """Boolean mask [B, T, S]: True = attendable."""
    kv_pos = torch.arange(kv_len, device=q_positions.device)[None, None, :]
    qp = q_positions[:, :, None]
    if causal:
        mask = kv_pos <= qp
    else:
        mask = torch.ones(qp.shape[:2] + (kv_len,), dtype=torch.bool,
                          device=q_positions.device)
    if sliding_window is not None:
        mask = mask & (kv_pos > qp - sliding_window)
    if seq_lengths is not None:
        mask = mask & (kv_pos < seq_lengths[:, None, None])
    return mask


def multi_head_attention(
    q: torch.Tensor,  # [B, T, n_heads, hd]
    k: torch.Tensor,  # cache layout [B, n_kv, S, hd]
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, T, S] bool
    scale: float,
    softcap: float | None = None,
) -> torch.Tensor:
    """Dense attention with GQA head-group mapping, f32 softmax (f64 for
    f64 q: a reference composition).

    Returns [B, T, n_heads, hd]."""
    B, T, n_heads, hd = q.shape
    n_kv = k.shape[1]
    g = n_heads // n_kv
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, T, n_kv, g, hd)
    scores = torch.einsum("btkgh,bksh->bkgts", qg.to(ct), k.to(ct))
    scores = scores * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    m = mask[:, None, None, :, :]
    scores = torch.where(m, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksh->btkgh", probs.to(v.dtype).to(ct), v.to(ct))
    return out.reshape(B, T, n_heads, hd).to(q.dtype)


def attention_scale(cfg: ModelConfig) -> float:
    if cfg.attention_multiplier is not None:  # granite
        return cfg.attention_multiplier
    if cfg.query_pre_attn_scalar is not None:  # gemma2
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.head_size ** -0.5


def self_attention_block(
    x: torch.Tensor,  # [B, T, D] (already normed)
    params: dict,
    cfg: ModelConfig,
    positions: torch.Tensor,  # [B, T]
    cache: KVLayerCache | None,
    cos: torch.Tensor | None,
    sin: torch.Tensor | None,
    sliding_window: int | None,
    attn_window: int | None = None,
    seq_lengths: torch.Tensor | None = None,
    dense_attention: bool = False,
) -> tuple[torch.Tensor, KVLayerCache | None]:
    """QKV projections, RoPE, cache update, attention, output projection.
    With a cache, RoPE and the cache update are one K4 launch.

    attn_window: upper bound on the live context (bucketed by the caller);
    attention then reads only that prefix of the cache (a view here).

    seq_lengths: [B] valid tokens of right-padded rows (a batch of
    embeddings); the dense masked path masks the keys past them. A causal
    model keeps K3 there, unlike the JAX package, which takes the dense path
    whenever seq_lengths is given: with the pads on the right, the causal
    mask alone keeps every valid query off the pad keys, and the dense path's
    f32 scores of a 32-row batch at the longest bucket would not fit a card.

    dense_attention: the path without a cache takes the dense masked
    attention at every head size (the train step: K3 has no backward).
    """
    B, T, D = x.shape
    hd = cfg.head_size

    x = tp_input(x)  # under tp and autograd: the projections' input gradient summed
    if "wqkv" in params:
        qdim = cfg.n_heads * hd
        kvdim = cfg.n_kv_heads * hd
        qkv = linear(x, params["wqkv"], params.get("wqkv.bias"))
        q, k, v = _split_fused(qkv, (qdim, kvdim, kvdim), cfg.fused_tp)
    else:
        q = linear(x, params["wq"], params.get("wq.bias"))
        k = linear(x, params["wk"], params.get("wk.bias"))
        v = linear(x, params["wv"], params.get("wv.bias"))
    # the JAX package's debug points, on every path and with no layer
    debug("query", q)
    debug("key", k)
    debug("value", v)
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)

    if cache is None and cos is not None:  # nothing to write: RoPE on its own
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if isinstance(cache, PagedLayerCache):
        out = _paged_attention(q, k, v, cache, cfg, positions, sliding_window, attn_window,
                               cos, sin)
        out = out.reshape(B, T, cfg.n_heads * hd)
        return _row_parallel_linear(out, params["wo"], params.get("wo.bias")), cache

    if cache is not None:
        # K4 on the dense cache (B pages of S slots, row b on page b): RoPE
        # on q and k and the write, one launch
        q = kv_write(dense_pool_view(cache.k), dense_pool_view(cache.v), k, v,
                     dense_page_table(B, k.device), positions, q=q, cos=cos, sin=sin)
        k_att, v_att = cache.k, cache.v
        if attn_window is not None and attn_window < k_att.shape[2]:
            k_att = k_att[:, :, :attn_window]
            v_att = v_att[:, :, :attn_window]
    else:
        k_att, v_att = k.transpose(1, 2), v.transpose(1, 2)  # [B, n_kv, T, hd]
    kv_len = k_att.shape[2]
    scale = attention_scale(cfg)

    if cache is not None and T == 1 and cfg.causal and hd in HEAD_SIZES:
        # K2 on the dense cache, cut to the window (a view): B pages of
        # kv_len slots, row b on page b, its live keys those <= its position
        out = paged_decode(q[:, 0], dense_pool_view(k_att), dense_pool_view(v_att),
                           dense_page_table(B, q.device), positions[:, 0] + 1, scale,
                           softcap=cfg.attn_logit_softcap, window=sliding_window)[:, None]
    elif T > 1 and cfg.causal and hd in HEAD_SIZES and not dense_attention:
        # K3: unlike the JAX gate (head_size % 128, a Mosaic limit), any
        # head size the kernel is built for takes it, Llama-3.2-1B's 64 too
        out = flash_prefill(
            q.transpose(1, 2),
            k_att.to(q.dtype),
            v_att.to(q.dtype),
            positions[:, 0],
            scale,
            softcap=cfg.attn_logit_softcap,
            window=sliding_window,
        ).transpose(1, 2)
    else:
        mask = attention_scores_mask(
            positions, kv_len, cfg.causal, sliding_window, seq_lengths
        )
        out = multi_head_attention(
            q, k_att, v_att, mask, scale, cfg.attn_logit_softcap
        )
    out = out.reshape(B, T, cfg.n_heads * hd)
    out = _row_parallel_linear(out, params["wo"], params.get("wo.bias"))
    return out, cache


def _paged_attention(q, k, v, cache: PagedLayerCache, cfg: ModelConfig, positions,
                     sliding_window, attn_window, cos, sin) -> torch.Tensor:
    """The paged branch (`jlama_tpu/nn/layers.py:255-393`): rotate q and k
    and write the new rows into the pool (one K4 launch), then T == 1 takes
    K2 over the live pages, T > 1 takes K3 over the gathered live window,
    and what neither kernel is built for takes the dense masked path. q, k
    before RoPE; q [B, T, H, hd] -> [B, T, H, hd]."""
    B, T, H, hd = q.shape
    q = write_kv_layer(cache.k_pool, cache.v_pool, k, v, cache.page_tables, positions, q=q,
                       cos=cos, sin=sin)
    ps = page_size_of(cache.k_pool)
    page_tables = cache.page_tables
    if attn_window is not None:
        # static live-context bound: only the page-table columns that can
        # hold tokens < attn_window
        page_tables = page_tables[:, : min(-(-attn_window // ps), page_tables.shape[1])]
    scale = attention_scale(cfg)
    softcap = cfg.attn_logit_softcap
    kernel_ok = cfg.causal and hd in HEAD_SIZES
    if T == 1 and kernel_ok:
        out = paged_decode(q[:, 0], cache.k_pool, cache.v_pool, page_tables,
                           positions[:, 0] + 1, scale, softcap=softcap, window=sliding_window)
        return out[:, None]
    k_g, v_g = gather_kv_layer(cache.k_pool, cache.v_pool, page_tables, dtype=q.dtype)
    k_att, v_att = k_g.transpose(1, 2), v_g.transpose(1, 2)  # [B, n_kv, S, hd] views
    if T > 1 and kernel_ok:
        return flash_prefill(q.transpose(1, 2), k_att, v_att, positions[:, 0], scale,
                             softcap=softcap, window=sliding_window).transpose(1, 2)
    mask = attention_scores_mask(positions, k_att.shape[2], cfg.causal, sliding_window)
    return multi_head_attention(q, k_att, v_att, mask, scale, softcap)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_block(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    x = tp_input(x)  # column-parallel w13 / w1, w3
    if "w13" in params:  # fused gate+up (see models.base.fuse_params)
        h = linear(x, params["w13"])
        half = h.shape[-1] // 2
        g, u = _split_fused(h, (half, half), cfg.fused_tp)
        return _row_parallel_linear(activation(g, cfg.activation) * u, params["w2"])
    if "w3" in params:  # gated (llama family): w2(act(w1(x)) * w3(x))
        gate = activation(linear(x, params["w1"]), cfg.activation)
        up = linear(x, params["w3"])
        return _row_parallel_linear(gate * up, params["w2"])
    # classic 2-layer MLP with biases (gpt2/bert)
    h = activation(linear(x, params["w1"], params.get("w1.bias")), cfg.activation)
    return _row_parallel_linear(h, params["w2"], params.get("w2.bias"))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


_PLAIN_FLOAT_EXPERTS = contextvars.ContextVar("plain_float_experts", default=False)


@contextlib.contextmanager
def plain_float_experts():
    """Inside it, float experts run `_moe_float_plain` on every device: the
    card's route rounds x and the down projection to bf16 (ROADMAP §3),
    the plain one does not at f32 activations. It reads the grouping back
    to the host, so it is for checks (`scripts/train_check.py`'s witness
    of the card route's rounding), not for a served step."""
    tok = _PLAIN_FLOAT_EXPERTS.set(True)
    try:
        yield
    finally:
        _PLAIN_FLOAT_EXPERTS.reset(tok)


def moe_block(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mixture-of-experts FFN with top-k routing (`jlama_tpu/nn/layers.py:
    moe_block`): the router in f32, `torch.topk` over the experts and a
    softmax over the k chosen, each selection through its expert's gated MLP,
    weighted by its f32 routing weight, the k summed in index order in f32
    (`_moe_ragged`'s combine), then x's dtype.

    q4 experts (`experts.w1`, `experts.w3` [E, H, D], `experts.w2` [E, D, H])
    go through K6 (`ops/moe_q4.py`), grouped once for the three projections,
    gate and up in one launch: on the card with no host sync, so a decode
    step stays capturable. The JAX package takes two routes there, which
    round differently (`_moe_gathered` at B·T·K ≤ 8 with exact f32
    dequantization, `_moe_ragged` above with the weights rounded to bf16);
    on the card K6's decode route computes the first's function and its
    prefill route the second's (past `ops.moe_q4.decode_max_r()`
    selections), and on the CPU its plain version computes the first's at
    every size (f32 x is cast to bf16 on the card, ROADMAP §3). Float experts
    (`experts.w*` [E, out, in], or `experts.w*_t` [E, in, out] after
    `models.base.prepare_moe_ragged`) take `_moe_ragged`'s grouped products:
    on the card `ops/moe_float.py` (K6's grouping and gather, the card's
    grouped product, no host sync), on the CPU (or inside
    `plain_float_experts`) `_moe_float_plain`.

    Expert parallelism (`jlama_tpu/nn/layers.py:509-560`): inside a tp
    context whose expert stacks hold fewer than the model's E experts (each
    rank E/tp, `parallel/mesh.py`), this rank's are lo = rank · E_local
    onward. The router is replicated, so every rank routes over the model's
    experts; K6 (or the float route) computes only the selections in
    [lo, lo + E_local), the others give rows of 0 and read no weight; the
    combine runs in f32 and `tp_reduce` sums the f32 partials over the
    ranks before the cast to x's dtype, as the JAX package's psum does."""
    B, T, D = x.shape
    K = cfg.n_experts_per_token
    router = params["router"]
    # the router as the JAX package runs it: a float router in the
    # activation dtype, its products exact in f32 and summed there
    logits = linear(x, router, out_dtype=torch.float32)
    topk_w, topk_idx = torch.topk(logits, K, dim=-1)
    topk_w = torch.softmax(topk_w, dim=-1)
    e = topk_idx.reshape(B * T, K).to(torch.int32)
    w1 = params.get("experts.w1")
    n_local = params.get("experts.w1", params.get("experts.w1_t")).shape[0]
    ctx = current()
    ep = ctx is not None and n_local < cfg.n_experts
    lo = ctx.group.rank * n_local if ep else None
    # under autograd a rank's experts give only their part of the gradients
    # of the experts' input and of the routing weights (so of the replicated
    # router): both are summed over the ranks
    xf = tp_input(x).reshape(B * T, D)
    topk_w = tp_input(topk_w)
    if isinstance(w1, QArray):
        groups = moe_groups(e, n_local, lo or 0)
        gate, up = moe_q4_gate_up(xf, w1, params["experts.w3"], e, groups=groups, lo=lo)
        h = (activation(gate, cfg.activation) * up).reshape(B * T * K, -1)
        y = moe_q4_matmul(h, params["experts.w2"], e.reshape(-1), out_dtype=torch.float32,
                          groups=groups, lo=lo)
    elif xf.device.type == "cpu" or _PLAIN_FLOAT_EXPERTS.get():
        y = _moe_float_plain(xf, params, cfg, e, lo)
    else:
        t = "experts.w1_t" in params
        w = [stack_in_out(params[f"experts.{k}" + ("_t" if t else "")], t)
             for k in ("w1", "w3", "w2")]
        y = moe_float_experts(xf, *w, e, n_local,
                              lambda g: activation(g, cfg.activation), lo)
    y = (y.reshape(B * T, K, D) * topk_w.reshape(B * T, K, 1)).sum(dim=1)
    if ep:
        y = tp_reduce(y.contiguous())  # the f32 partials of each rank's experts
    return y.reshape(B, T, D).to(x.dtype)


def _moe_float_plain(xf: torch.Tensor, params: dict, cfg: ModelConfig,
                     e: torch.Tensor, lo: int | None = None) -> torch.Tensor:
    """Float experts, one group of selections per expert: weights in x's
    dtype, f32 sums, gate and up in x's dtype; the down projection in f32
    for stacks in the grouped layout `experts.w*_t` (`_moe_ragged`'s grouped
    matmuls), in x's dtype for the loader's `experts.w*` (the JAX package's
    per-expert path, `linear(gate * up, w2)`). [N, K] ids -> [N·K, D] f32.
    The CPU's path, and the card tests' reference for `ops/moe_float.py` (on
    any device; the grouping is read back to the host). lo: the model's id
    of the stacks' first expert under expert parallelism; rows of experts
    outside the stacks stay 0."""
    ragged = "experts.w1_t" in params  # [E, in, out]; else [E, out, in]
    dt = xf.dtype

    def mm(a, key, ex, out_dtype):
        w = params[key + ("_t" if ragged else "")][ex].to(dt)
        w = w if ragged else w.t()
        return torch.matmul(a.to(torch.float32), w.to(torch.float32)).to(out_dtype)

    K = cfg.n_experts_per_token
    ef = e.reshape(-1).long() - (lo or 0)
    n_local = params["experts.w1" + ("_t" if ragged else "")].shape[0]
    # each selection's copy of its token's row, in f32 (x's values), one copy
    # for the gate and one for the up projection: under autograd each
    # projection's gradient of x sums its selections in f32 and rounds once,
    # as the JAX package's products batched over the experts do
    x1, x3 = (xf.to(torch.float32).repeat_interleave(K, dim=0) for _ in range(2))
    y = torch.zeros((ef.numel(), xf.shape[1]), dtype=torch.float32, device=xf.device)
    for ex in torch.unique(ef).tolist():
        if not 0 <= ex < n_local:  # another rank's expert: the row stays 0
            continue
        idx = (ef == ex).nonzero()[:, 0]
        h = activation(mm(x1[idx], "experts.w1", ex, dt), cfg.activation) \
            * mm(x3[idx], "experts.w3", ex, dt)
        y[idx] = mm(h, "experts.w2", ex, torch.float32 if ragged else dt).to(torch.float32)
    return y
