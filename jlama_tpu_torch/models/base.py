"""Transformer forward pass over a per-layer parameter list (counterpart of
`jlama_tpu/models/base.py`, its "unrolled" layer mode; there is no scan).

Param tree layout (leaves are tensors or QArrays):
  params = {
    "embed": [V, D],                     # token embeddings
    "wpe": [P, D],                       # learned positions (gpt2/bert)
    "token_type_embed": [2, D],          # bert
    "embed_norm.weight/.bias": [D],      # bert's embedding LayerNorm
    "layers": [ {key: tensor} per layer ],  # MoE: router + experts.w1/w2/w3 [E, ...]
    "final_norm.weight" (+ ".bias"): [D],  # absent for bert
    "lm_head": [V, D],                   # absent when tied
    "pooler.weight/.bias", "classifier.weight/.bias"  # bert's heads
  }
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..nn import layers as L
from ..nn.qarray import QArray
from ..nn.rope import rope_cos_sin, rope_frequencies
from ..ops.linear import linear
from ..parallel import tp_forward


class KVCache(NamedTuple):
    """Dense per-layer KV cache: layers[l] = KVLayerCache(k, v), each
    [B, n_kv_heads, S, head_size]."""

    layers: list

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
             device="cpu") -> "KVCache":
        shape = (batch, cfg.n_kv_heads, max_len, cfg.head_size)
        return KVCache([
            L.KVLayerCache(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layers)
        ])

    @property
    def max_len(self) -> int:
        return self.layers[0].k.shape[2]


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor, positions: torch.Tensor,
           token_types: torch.Tensor | None, dtype) -> torch.Tensor:
    """Token rows, plus learned positions and token types where the model has
    them, then BERT's embedding LayerNorm (`jlama_tpu/models/base.py:_embed`).
    Positions past the table read its last row, as JAX's gather clamps an
    out-of-range index: a chunked prefill's pads reach such positions when
    the page size does not divide the context."""
    emb = params["embed"]
    ctx = tp_forward.current()
    if ctx is not None and ctx.embed_vocab_sharded:
        # a vocabulary-sharded table: masked local gather + all-reduce
        x = tp_forward.sharded_vocab_gather(emb, tokens, ctx.group)
    elif isinstance(emb, QArray):
        # gather the rows FIRST, then dequantize only those
        x = emb[tokens].dequantize(torch.float32)
    else:
        x = emb[tokens].to(torch.float32)
    if cfg.embedding_scale is not None:
        x = x * cfg.embedding_scale
    if cfg.learned_pos_embeddings:
        wpe = params["wpe"]
        x = x + wpe[positions.clamp(0, wpe.shape[0] - 1)].to(torch.float32)
    if cfg.type_vocab_size and "token_type_embed" in params:
        tt = params["token_type_embed"]
        x = x + (tt[0] if token_types is None else tt[token_types]).to(torch.float32)
    x = x.to(dtype)
    if "embed_norm.weight" in params:  # bert
        x = L.layer_norm(x, params["embed_norm.weight"], params["embed_norm.bias"], cfg.norm_eps)
    return x


def _block(x, layer_params: dict, cfg: ModelConfig, positions, cache, cos, sin,
           sliding_window, attn_window=None, seq_lengths=None, dense_attention=False):
    """One transformer block: pre-norm, or BERT's post-norm encoder block."""
    if cfg.model_type == "bert":  # attention, add, norm; MLP, add, norm
        attn_out, cache = L.self_attention_block(
            x, layer_params, cfg, positions, cache, cos, sin, sliding_window, attn_window,
            seq_lengths, dense_attention,
        )
        x = L.norm(x + attn_out, layer_params, cfg, "attn_norm")
        x = L.norm(x + L.mlp_block(x, layer_params, cfg), layer_params, cfg, "ff_norm")
        return x, cache
    rm = cfg.residual_multiplier  # granite; None: 1 (no multiply launched)
    h = L.norm(x, layer_params, cfg, "attn_norm")
    attn_out, cache = L.self_attention_block(
        h, layer_params, cfg, positions, cache, cos, sin, sliding_window, attn_window,
        seq_lengths, dense_attention,
    )
    if cfg.post_attn_norm:
        attn_out = L.norm(attn_out, layer_params, cfg, "post_attn_norm")
    x = x + (attn_out if rm is None else rm * attn_out)
    h = L.norm(x, layer_params, cfg, "ff_norm")
    ff = L.moe_block(h, layer_params, cfg) if cfg.n_experts else L.mlp_block(h, layer_params, cfg)
    if cfg.post_ff_norm:
        ff = L.norm(ff, layer_params, cfg, "post_ff_norm")
    x = x + (ff if rm is None else rm * ff)
    return x, cache


def rope_inv_freq(cfg: ModelConfig, device) -> torch.Tensor | None:
    """The RoPE inverse frequencies on `device`; None for a model without
    RoPE (learned positions: `rope_theta` 0)."""
    if not cfg.rope_theta:
        return None
    return torch.from_numpy(rope_frequencies(cfg)).to(device)


def forward_hidden(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T] absolute positions
    kv_cache: KVCache | tuple[list, torch.Tensor] | None,
    dtype=torch.bfloat16,
    attn_window: int | None = None,
    inv_freq: torch.Tensor | None = None,
    token_types: torch.Tensor | None = None,
    seq_lengths: torch.Tensor | None = None,
    dense_attention: bool = False,
) -> tuple[torch.Tensor, KVCache | tuple[list, torch.Tensor] | None]:
    """Run embedding + all transformer layers. Returns (hidden [B,T,D], cache).

    kv_cache: None, a dense `KVCache`, or a paged cache `(states,
    page_tables)`: a per-layer list of `PagedKVState` pools (views of the
    stacked pool, see `kv.paged.PagedKVCache.layer_states`) and one [B, P]
    int32 page-table tensor. Every cache is written in place and returned as
    it came.

    inv_freq: the RoPE inverse frequencies on the tokens' device (see
    `rope_inv_freq`); a caller in a decode loop passes them so the step does
    no host-to-device copy, which would synchronize the stream.

    token_types: BERT's segment ids [B, T] (None: all 0). seq_lengths: [B]
    valid tokens per right-padded row; the dense attention path masks the
    keys past them (a batch of embeddings).

    dense_attention: a forward without a cache takes the dense masked
    attention at every head size, never K3 (the train step,
    `parallel/train.py`: K3 has no backward).
    """
    x = _embed(params, cfg, tokens, positions, token_types, dtype)
    return forward_layers(params, cfg, x, positions, kv_cache, attn_window, inv_freq,
                          seq_lengths, dense_attention=dense_attention), kv_cache


def forward_layers(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                   kv_cache, attn_window: int | None = None,
                   inv_freq: torch.Tensor | None = None,
                   seq_lengths: torch.Tensor | None = None,
                   first_layer: int = 0, dense_attention: bool = False) -> torch.Tensor:
    """The transformer layers of `params["layers"]` over hidden states x
    [B, T, D] (`forward_hidden` without the embedding; the caches as
    there, indexed by the tree's own layers). A pipeline stage's tree holds
    the model's layers `first_layer` onward, which gemma2's alternation of
    sliding and global attention counts from."""
    if cfg.rope_theta:
        if inv_freq is None:
            inv_freq = rope_inv_freq(cfg, positions.device)
        cos, sin = rope_cos_sin(positions, inv_freq)
    else:
        cos = sin = None

    # per-layer static windows (gemma2 alternates sliding/global attention;
    # the mistral window is ignored, as in the JAX package)
    for l, layer in enumerate(params["layers"]):
        sw = None
        if (cfg.sliding_window is not None and cfg.model_type == "gemma2"
                and (first_layer + l) % 2 == 0):
            sw = cfg.sliding_window
        if kv_cache is None:
            cache_l = None
        elif isinstance(kv_cache, KVCache):
            cache_l = kv_cache.layers[l]
        else:
            states, page_tables = kv_cache
            cache_l = L.PagedLayerCache(states[l].k_pool, states[l].v_pool, page_tables)
        x, _ = _block(x, layer, cfg, positions, cache_l, cos, sin, sw, attn_window, seq_lengths,
                      dense_attention)
    return x


def _interleave_concat(ts, dim: int, tp: int) -> torch.Tensor:
    """Concatenate along `dim` with the tp ranks interleaved: the result's
    rows, viewed as tp equal blocks, give block i = [t0's block i; t1's
    block i; ...], so that rank i's contiguous slice of a fused weight holds
    exactly its own (q_i, k_i, v_i) or (gate_i, up_i) rows
    (`jlama_tpu/models/base.py:_interleave_concat`). tp = 1: a plain
    concat."""
    if tp == 1:
        return torch.cat(ts, dim=dim)
    dim = dim % ts[0].ndim
    parts = [t.reshape(*t.shape[:dim], tp, t.shape[dim] // tp, *t.shape[dim + 1:]) for t in ts]
    cat = torch.cat(parts, dim=dim + 1)
    return cat.reshape(*cat.shape[:dim], -1, *cat.shape[dim + 2:])


def _concat_rows(ws, tp: int = 1):
    """Concatenate weights along the output-row axis (tensors or q4/q8
    QArrays: block scales are per row along the input axis, so a row concat
    never crosses a block), interleaved per tp rank when tp > 1. q4s is
    refused: fuse first, then re-quantize
    (`ops/w8a8.py::prepare_params_for_w8a8`), as the JAX scheduler does."""
    if isinstance(ws[0], QArray):
        if any(w.fmt == "q4s" for w in ws):
            raise ValueError("q4s weights are not fused: fuse the q4 weights first, "
                             "then convert them with prepare_params_for_w8a8")
        return QArray(
            _interleave_concat([w.data for w in ws], -2, tp),
            _interleave_concat([w.scales for w in ws], -2, tp),
            ws[0].fmt,
        )
    return _interleave_concat(ws, -2, tp)


def _fuse_layer_dict(d: dict, tp: int = 1) -> dict:
    out = dict(d)
    qkv = [d.get("wq"), d.get("wk"), d.get("wv")]
    fmts = {w.fmt if isinstance(w, QArray) else None for w in qkv if w is not None}
    biases = [d.get("wq.bias"), d.get("wk.bias"), d.get("wv.bias")]
    n_bias = sum(b is not None for b in biases)
    # bias presence must be uniform (all three or none)
    if all(w is not None for w in qkv) and len(fmts) == 1 and n_bias in (0, 3):
        out["wqkv"] = _concat_rows(qkv, tp)
        if n_bias == 3:
            out["wqkv.bias"] = _interleave_concat(biases, -1, tp)
        for k in ("wq", "wk", "wv", "wq.bias", "wk.bias", "wv.bias"):
            out.pop(k, None)
    w1, w3 = d.get("w1"), d.get("w3")
    if (
        w1 is not None
        and w3 is not None
        and "w1.bias" not in d
        and isinstance(w1, QArray) == isinstance(w3, QArray)
        and (not isinstance(w1, QArray) or w1.fmt == w3.fmt)
    ):
        out["w13"] = _concat_rows([w1, w3], tp)
        out.pop("w1")
        out.pop("w3")
    return out


def fuse_params(params: dict, tp: int = 1) -> dict:
    """Fuse QKV into one [qdim+2*kvdim, D] matmul and gate/up into one
    [2H, D] matmul (one-time concat; the same rows hit the same reduction,
    so the numbers do not change). tp > 1 interleaves the rows per tp rank
    (`_interleave_concat`), for `parallel.mesh.shard_params`; on one device
    such a tree runs with `cfg.fused_tp = tp`. MoE experts stay as they are:
    a concat of Mixtral-8x7B's w1 and w3 would copy 18.8 GB."""
    out = dict(params)
    out["layers"] = [_fuse_layer_dict(d, tp) for d in params["layers"]]
    return out


def prepare_moe_ragged(params: dict) -> dict:
    """Float MoE experts transposed once into the grouped-matmul layout
    `experts.w*_t` [E, in, out] (`jlama_tpu/models/base.py:prepare_moe_ragged`).
    q4 experts stay as they are: K6 reads their [E, out, in] layout, whose
    block-32 quantization axis a transpose would move."""
    out = dict(params)
    layers = []
    for d in params["layers"]:
        if "experts.w1" in d and not isinstance(d["experts.w1"], QArray):
            d = dict(d)
            for k in ("experts.w1", "experts.w2", "experts.w3"):
                d[k + "_t"] = d.pop(k).transpose(-1, -2)
        layers.append(d)
    out["layers"] = layers
    return out


def check_moe_device(params: dict, device) -> None:
    """Raise where float MoE experts cannot take the card's grouped product
    (`ops/moe_float.py`): its rows are 16-byte multiples, so each stack's in
    and out sizes must be multiples of 8. Every layout is taken: q4 experts
    (K6), float `experts.w*` [E, out, in] and `experts.w*_t` [E, in, out]."""
    if torch.device(device).type == "cpu":
        return
    for d in params["layers"]:
        for k in ("experts.w1", "experts.w2", "experts.w3"):
            w = d.get(k, d.get(k + "_t"))
            if w is not None and not isinstance(w, QArray) and (w.shape[-1] % 8 or
                                                                w.shape[-2] % 8):
                raise ValueError(f"float MoE experts {k} {tuple(w.shape)}: the card's "
                                 "grouped product needs both sizes a multiple of 8")


def final_hidden(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Apply the output norm."""
    return L.norm(hidden, params, cfg, "final_norm")


def lm_logits(params: dict, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project to f32 vocab logits (f64 from f64 hidden states: a reference
    composition) with the multiplier/softcap semantics."""
    h = final_hidden(params, cfg, hidden)
    w = params.get("lm_head", params["embed"])
    ctx = tp_forward.current()
    if ctx is not None and ctx.lm_head_vocab_sharded:
        h = tp_forward.tp_input(h)  # each rank's columns give part of h's gradient
    logits = linear(h, w, out_dtype=torch.promote_types(h.dtype, torch.float32))
    if ctx is not None and ctx.lm_head_vocab_sharded:
        # each rank computed its vocabulary columns: gather them in rank
        # order (the multiplier and softcap then apply to the full logits)
        logits = tp_forward.gather_vocab_logits(logits, ctx.group)
    if cfg.logit_multiplier is not None:
        logits = logits / cfg.logit_multiplier
    if cfg.final_logit_softcap is not None:
        logits = torch.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits


def forward_logits(params, cfg, tokens, positions, kv_cache=None, dtype=torch.bfloat16):
    hidden, cache = forward_hidden(params, cfg, tokens, positions, kv_cache, dtype)
    return lm_logits(params, cfg, hidden), cache


def params_to(params: dict, device) -> dict:
    """The param tree with every tensor and QArray moved to `device`."""
    def mv(v):
        if isinstance(v, list):
            return [mv(x) for x in v]
        if isinstance(v, dict):
            return {k: mv(x) for k, x in v.items()}
        return v.to(device)

    return mv(params)
